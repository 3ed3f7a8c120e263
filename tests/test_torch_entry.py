"""The port's multichip dry run (ray_tpu_torch/entry.py) against the JAX
harness (``__graft_entry__.py``), on the CPU.

  - ``dryrun_layout(n)`` is the harness's rule, written out as a table.
  - The dry run's rank body over gloo at n = 4 ({sp:2, tp:2}) and n = 8
    ({fsdp:2, sp:2, tp:2}), from the flax init of
    ``ray_tpu.train.gspmd.build_llama_train_state`` (carried across with
    ``params_from_flax``) and the same numpy tokens, against that JAX
    step on a JAX mesh of the same shape over the conftest's virtual
    devices: both losses within 1e-5 relative in fp32 (the two sum in
    different orders, nothing more) and within 1e-2 at tiny's bf16
    default (bf16 rounds at other places in the two), as
    tests/test_torch_distributed.py bounds the sharded step.
  - ``dryrun_multichip(8, device="cpu")`` end to end, in a process of
    its own: both of the harness's lines with its mesh dicts, the
    pipeline's loss falling over six steps, no TPU figure.
  - The refusals: no card, or fewer cards than ranks, raise before any
    process starts.

The rank jobs and then the end-to-end run go on while this process
computes the JAX side.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_dist_ranks as ranks
from tests.conftest import force_cpu_jax

from ray_tpu.models import llama as jl
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.train import gspmd as jg
from ray_tpu_torch import entry as te

force_cpu_jax()

LOSS_REL = {"float32": 1e-5, "bfloat16": 1e-2}
DTYPES = list(LOSS_REL)
NS = (4, 8)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
END_TO_END = ("import json; from ray_tpu_torch.entry import "
              "dryrun_multichip; "
              "print('RESULT ' + json.dumps(dryrun_multichip(8, "
              "device='cpu')), flush=True)")
# the harness's rule (__graft_entry__.py _dryrun_body), written out
LAYOUTS = {1: dict(dp=1, fsdp=1, sp=1, tp=1),
           2: dict(dp=1, fsdp=1, sp=1, tp=2),
           3: dict(dp=3, fsdp=1, sp=1, tp=1),
           4: dict(dp=1, fsdp=1, sp=2, tp=2),
           6: dict(dp=3, fsdp=1, sp=1, tp=2),
           8: dict(dp=1, fsdp=2, sp=2, tp=2),
           16: dict(dp=2, fsdp=2, sp=2, tp=2)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _batch(n):
    """(rows, sequence) of the dry run over n devices: dp·fsdp rows of
    64·sp tokens."""
    lay = LAYOUTS[n]
    return lay["dp"] * lay["fsdp"], 64 * lay["sp"]


def _tokens(n):
    rows, seq = _batch(n)
    return np.random.default_rng(1).integers(
        0, jl.LlamaConfig.tiny().vocab_size, size=(rows, seq),
        dtype=np.int32)


def _jax_run(init, tokens, n):
    """{"mesh": the JAX mesh's shape, dtype: [loss, loss2]}: the JAX
    train step on the harness's mesh over n virtual devices, two steps
    on the same tokens, as ``_dryrun_body`` takes them."""
    lay = LAYOUTS[n]
    spec = jmesh.MeshSpec(dp=-1, fsdp=lay["fsdp"], sp=lay["sp"],
                          tp=lay["tp"])
    mesh = jmesh.make_mesh(spec, devices=jax.devices()[:n])
    out = {"mesh": dict(mesh.shape)}
    rows, seq = _batch(n)
    for dtype in DTYPES:
        jcfg = dataclasses.replace(jl.LlamaConfig.tiny(),
                                   dtype=getattr(jnp, dtype))
        params, opt, step, _ = jg.build_llama_train_state(
            jcfg, mesh, batch_size=rows, seq_len=seq)
        start = _flat(jax.tree_util.tree_map(np.asarray, params))
        assert all(np.array_equal(start[k], init[k]) for k in init)
        params, opt, loss = step(params, opt, tokens)
        _, _, loss2 = step(params, opt, tokens)
        out[dtype] = [float(loss), float(loss2)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the rank jobs' results by n and rank, the JAX results by n, the
    end to end run's (returncode, stdout, stderr)).  The rank jobs start
    first and the end to end run once they are done, so that at most
    twelve processes share the host's cores."""
    work = tmp_path_factory.mktemp("dryrun")
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    # the draw of jg.build_llama_train_state(rng_seed=0); checked there
    init = _flat(jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: jl.LlamaModel(jcfg).init(r, jnp.zeros((1, 64), jnp.int32))
    )(jax.random.PRNGKey(0))["params"]))
    np.savez(work / "params.npz", **init)
    tokens = {n: _tokens(n) for n in NS}
    started = {n: ranks.start("dryrun_cases", n, str(work / f"n{n}"),
                              str(work / "params.npz"), tokens[n], DTYPES)
               for n in NS}
    e2e = None
    try:
        want = {NS[0]: _jax_run(init, tokens[NS[0]], NS[0])}
        got = {n: ranks.finish(ctx, n, str(work / f"n{n}"), timeout=180)
               for n, ctx in started.items()}
        e2e = subprocess.Popen(
            [sys.executable, "-c", END_TO_END], cwd=ROOT,
            env=dict(os.environ, RT_TMPDIR=str(work / "rt")),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for n in NS[1:]:
            want[n] = _jax_run(init, tokens[n], n)
        out, err = e2e.communicate(timeout=240)
    finally:
        for ctx in started.values():     # no rank outlives a failure
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        if e2e is not None and e2e.poll() is None:
            e2e.kill()
            e2e.communicate()
    return got, want, (e2e.returncode, out, err)


@pytest.mark.parametrize("n", sorted(LAYOUTS))
def test_dryrun_layout_is_the_harness_rule(n):
    assert te.dryrun_layout(n).axis_sizes() == dict(pp=1, **LAYOUTS[n])


def test_dryrun_tokens_are_the_seeded_draw():
    cfg = te.LlamaConfig.tiny()
    for n in NS:
        np.testing.assert_array_equal(te.dryrun_tokens(cfg, *_batch(n)),
                                      _tokens(n))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_dryrun_body_matches_the_jax_step(runs, n, dtype):
    """Every rank's two losses equal the JAX step's on the same mesh
    shape, from the same init and tokens, and its line is the
    harness's, mesh dict and all."""
    got, want, _ = runs
    jlosses = want[n][dtype]
    for rank in got[n]:
        r = rank[dtype]
        assert r["losses"] == got[n][0][dtype]["losses"]  # one global mean
        assert r["mesh"] == want[n]["mesh"]
        for a, b in zip(r["losses"], jlosses):
            assert abs(a - b) <= LOSS_REL[dtype] * abs(b), (r, jlosses)
        a, b = r["losses"]
        assert r["line"] == (f"dryrun_multichip ok: mesh={want[n]['mesh']} "
                             f"loss {a:.4f} -> {b:.4f}")
        assert r["device"] == "cpu"


def test_dryrun_multichip_on_cpu_end_to_end(runs):
    """``dryrun_multichip(8, device="cpu")``: eight gloo ranks print the
    harness's first line; the {pp:2, fsdp:2, tp:2} pipeline's loss falls
    over six steps and its line carries no TPU figure."""
    _, want, (rc, out, err) = runs
    assert rc == 0, err[-4000:]
    result = json.loads(out.split("RESULT ", 1)[1])
    assert result["mesh"] == want[8]["mesh"]
    a, b = result["losses"]
    assert a == a and a > 0 and b < 1.5 * a
    assert len(result["ranks"]) == 8
    assert all(r["device"] == "cpu" for r in result["ranks"])
    pipe = result["pipeline"]
    assert pipe["mesh"] == {"pp": 2, "dp": 1, "fsdp": 2, "sp": 1, "tp": 2}
    assert len(pipe["losses"]) == 6 and pipe["losses"][-1] < pipe["losses"][0]
    assert all(0 <= x < 100 for x in pipe["bubble_pct"])
    # the stage processes' log lines reach this stdout from another
    # thread of the driver, so the pipeline's line may share a line
    # with one of theirs; the ranks' line comes first
    first, second = result["line"], pipe["line"]
    assert first in out.splitlines() and second in out
    assert out.index(first) < out.index(second)
    assert first.startswith(
        f"dryrun_multichip ok: mesh={want[8]['mesh']} loss ")
    assert second.startswith(
        "dryrun_multichip pp ok: mesh={'pp': 2, 'dp': 1, 'fsdp': 2, "
        "'sp': 1, 'tp': 2} loss ")
    assert " bubble " in second and " train_tokens_per_s " in second
    assert "29.3k" not in out and "MFU" not in out


def _no_spawn(*_args, **_kw):
    raise AssertionError("a rank process was started")


def test_dryrun_without_a_card_names_the_cpu(monkeypatch):
    import torch.multiprocessing as mp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mp, "start_processes", _no_spawn)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        te.dryrun_multichip(4)


def test_dryrun_refuses_more_ranks_than_cards(monkeypatch):
    import torch.multiprocessing as mp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(mp, "start_processes", _no_spawn)
    with pytest.raises(RuntimeError, match=r"sees 2 card"):
        te.dryrun_multichip(4)
    with pytest.raises(ValueError, match="cuda"):
        te.dryrun_multichip(2, device="cuda:1")


def test_entry_main_arguments(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert te._parse_args([]) == (4, None)
    assert te._parse_args(["2"]) == (2, None)
    assert te._parse_args(["--cpu"]) == (8, "cpu")
    assert te._parse_args(["4", "--cpu"]) == (4, "cpu")
