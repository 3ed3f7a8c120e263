"""Durable workflows (ray_tpu_torch.workflow) on a port cluster.

The workflow cases of tests/test_dag_workflow.py on the port: a finished
workflow is served from storage without re-running its steps, a failed
one resumes past the steps that finished, continuations, ``run_async``
and ``delete``, actors refused.  Then what a step of the port returns:
a torch tensor comes back from storage bit for bit, in a process that
did not run the step; and the port writes the reference's on-disk
format, which ray_tpu's own WorkflowStorage reads back.

The storage root sits in the test's tmp dir (the default is
``~/.ray_tpu/workflows``).  Remote functions are defined inside the
tests, so cloudpickle sends them by value.
"""

import os

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import workflow

from tests.torch_waits import bounded

torch.set_num_threads(2)   # six xdist workers share the test machine

CALL_S = 120


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    bounded(lambda: rt.init(num_cpus=4, object_store_memory=64 << 20),
            120, "rt.init")
    try:
        yield rt
    finally:
        bounded(rt.shutdown, 60, "rt.shutdown")
        os.environ.pop("RT_TMPDIR", None)


@pytest.fixture
def wf_storage(cluster, tmp_path):
    workflow.init(str(tmp_path / "wf"))
    yield str(tmp_path / "wf")
    workflow.init(None)


def _run(dag, **kw):
    return bounded(lambda: workflow.run(dag, **kw), CALL_S, "workflow.run")


def test_workflow_run_and_memoized_rerun(wf_storage, tmp_path):
    marker = str(tmp_path / "runs")

    @rt.remote
    def record(x):
        with open(marker, "a") as f:
            f.write("x")
        return x * 10

    @rt.remote
    def total(*parts):
        return sum(parts)

    dag = total.bind(record.bind(1), record.bind(2))
    assert _run(dag, workflow_id="w1") == 30
    assert workflow.get_status("w1") == "SUCCEEDED"
    assert workflow.get_output("w1") == 30
    n_runs = len(open(marker).read())
    assert n_runs == 2
    # finished workflow: result served from storage, steps NOT re-run
    assert _run(dag, workflow_id="w1") == 30
    assert len(open(marker).read()) == n_runs
    assert ("w1", "SUCCEEDED") in workflow.list_all()


def test_workflow_crash_resume_skips_done_steps(wf_storage, tmp_path):
    ok_flag = str(tmp_path / "ok")
    count_a = str(tmp_path / "a_runs")

    @rt.remote(max_retries=0)
    def step_a():
        with open(count_a, "a") as f:
            f.write("x")
        return 7

    @rt.remote(max_retries=0)
    def step_b(a):
        if not os.path.exists(ok_flag):
            raise RuntimeError("transient outage")
        return a + 1

    dag = step_b.bind(step_a.bind())
    with pytest.raises(rt.RayError):
        _run(dag, workflow_id="w2")
    assert workflow.get_status("w2") == "FAILED"
    assert len(open(count_a).read()) == 1

    open(ok_flag, "w").close()  # outage over
    assert bounded(lambda: workflow.resume("w2"), CALL_S, "resume") == 8
    assert workflow.get_status("w2") == "SUCCEEDED"
    # step_a's checkpoint was reused — it ran exactly once overall
    assert len(open(count_a).read()) == 1


def test_workflow_continuation(wf_storage):
    @rt.remote
    def fib(n, a=0, b=1):
        if n == 0:
            return a
        return workflow.continuation(fib.bind(n - 1, b, a + b))

    assert _run(fib.bind(10), workflow_id="w3") == 55
    assert workflow.get_output("w3") == 55


def test_workflow_run_async_and_delete(wf_storage):
    @rt.remote
    def one():
        return 1

    fut = workflow.run_async(one.bind(), workflow_id="w4")
    assert fut.result(timeout=CALL_S) == 1
    workflow.delete("w4")
    with pytest.raises(ValueError):
        workflow.get_status("w4")


def test_workflow_rejects_actors(wf_storage):
    @rt.remote
    class A:
        def m(self):
            return 1

    with pytest.raises(TypeError):
        workflow.run(A.bind().m.bind(), workflow_id="w5")


def test_tensor_step_resumes_bit_for_bit_from_storage(wf_storage,
                                                      tmp_path):
    """A step returns a CPU tensor; the next step fails once.  On
    resume the tensor comes out of storage, not out of a re-run, equal
    bit for bit to the one the step made (bf16 and a non-contiguous
    view included), and the final output reads back the same."""
    ok_flag = str(tmp_path / "ok")
    count = str(tmp_path / "make_runs")

    @rt.remote(max_retries=0)
    def make(seed):
        import numpy as np
        import torch

        with open(count, "a") as f:
            f.write("x")
        g = np.random.default_rng(seed)
        w = torch.from_numpy(g.standard_normal((64, 48)).astype(np.float32))
        return {"w": w, "w_bf16": w.to(torch.bfloat16), "wt": w.t()}

    @rt.remote(max_retries=0)
    def use(made):
        if not os.path.exists(ok_flag):
            raise RuntimeError("transient outage")
        return made

    dag = use.bind(make.bind(7))
    with pytest.raises(rt.RayError):
        _run(dag, workflow_id="wt")
    assert workflow.get_status("wt") == "FAILED"
    open(ok_flag, "w").close()
    got = bounded(lambda: workflow.resume("wt"), CALL_S, "resume")
    assert len(open(count).read()) == 1, "the tensor step ran again"
    import numpy as np

    want = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (64, 48)).astype(np.float32))
    for out in (got, workflow.get_output("wt")):
        assert out["w"].dtype == torch.float32 and out["w"].device.type \
            == "cpu"
        assert torch.equal(out["w"], want)
        assert out["w_bf16"].dtype == torch.bfloat16
        assert torch.equal(out["w_bf16"], want.to(torch.bfloat16))
        assert torch.equal(out["wt"], want.t())


def test_storage_is_the_reference_format(wf_storage):
    """The port writes what ray_tpu's WorkflowStorage reads: the status,
    the output and the event log of a port workflow read back through
    the reference's storage class."""
    from ray_tpu.workflow.storage import WorkflowStorage as RefStorage

    @rt.remote
    def double(x):
        return 2 * x

    @rt.remote
    def add(a, b):
        return a + b

    assert _run(add.bind(double.bind(3), double.bind(4)),
                workflow_id="wref") == 14
    ref = RefStorage(wf_storage)
    assert ref.get_status("wref") == "SUCCEEDED"
    assert ref.load_result("wref") == 14
    assert ("wref", "SUCCEEDED") in ref.list_all()
    assert ref.read_log("wref")
