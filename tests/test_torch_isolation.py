"""The port stands alone: ray_tpu_torch and chip_smoke.py import nothing
of JAX or of ray_tpu, and the port's entry points never fall back to the
CPU on their own."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)   # six xdist workers share the test machine

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "ray_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ray_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_sources_import_nothing_of_jax_or_ray_tpu():
    assert len(PORT_FILES) > 10
    bad = [f"{p.relative_to(REPO)}:{line} imports {root}"
           for p in PORT_FILES for line, root in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


def test_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import ray_tpu_torch\nfrom ray_tpu.models import x\n"
                     "import jax.numpy as jnp\n")
    assert [r for _l, r in _imported_roots(probe)] == \
        ["ray_tpu_torch", "ray_tpu", "jax"]


def test_package_imports_with_jax_and_ray_tpu_blocked():
    """Every module of the port (and chip_smoke.py) imports in a fresh
    interpreter where jax, flax and ray_tpu cannot be imported."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'ray_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import ray_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    ray_tpu_torch.__path__, 'ray_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(' '.join(mods))\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'ray_tpu')\n"
        "               and sys.modules[k] is not None for k in sys.modules)\n"
        "print(len(mods))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    *_, listed, count = proc.stdout.strip().splitlines()
    assert int(count) >= 12
    for name in ("ray_tpu_torch.dag", "ray_tpu_torch.dag.execution",
                 "ray_tpu_torch.train.pipeline", "ray_tpu_torch.rllib",
                 "ray_tpu_torch.rllib.core.learner",
                 "ray_tpu_torch.rllib.env_runner"):
        assert name in listed.split(), name


def test_entry_points_raise_without_a_gpu(monkeypatch):
    """No device given and no CUDA: every entry point raises instead of
    running on the CPU; an explicit "cpu" is honoured."""
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.entry import entry
    from ray_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                            make_kv_pools)
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.mesh import Mesh
    from ray_tpu_torch.models.llama import LlamaStage
    from ray_tpu_torch.rllib.core.learner import PPOLearner
    from ray_tpu_torch.rllib.core.rl_module import ActorCriticModule
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.train.gspmd import (build_llama_stage_state,
                                           build_llama_train_state)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny()
    cuda_mesh = Mesh((torch.device("cuda"),), MeshSpec())
    for call in (lambda: resolve_device(), lambda: resolve_device("cuda"),
                 lambda: entry(), lambda: LlamaModel(cfg),
                 lambda: make_kv_pools(cfg, 16), lambda: LLMEngine(cfg),
                 lambda: make_mesh(), lambda: make_mesh(MeshSpec(dp=-1)),
                 lambda: build_llama_train_state(cfg, cuda_mesh),
                 lambda: LlamaStage(cfg, 0, 1, first=True),
                 lambda: build_llama_stage_state(
                     cfg, cuda_mesh, (0, 1), first=True, last=False,
                     microbatch_size=1, seq_len=8, num_microbatches=1),
                 lambda: ActorCriticModule(4, 2),
                 lambda: PPOLearner(ActorCriticModule(4, 2, device="cpu"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert make_mesh(devices=["cpu"]).device == torch.device("cpu")


def test_entry_on_cpu_builds_the_small_forward(monkeypatch):
    """entry(device="cpu") builds LlamaConfig.small() over [8, 512]
    tokens, and attention at that shape routes through flash_attention
    (its plain version on the CPU).  The bf16 forward itself is left to
    chip_smoke.py: a CPU bf16 forward of the small model is too slow
    for tier-1."""
    import ray_tpu_torch.entry as ent
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa

    built = []

    def meta_model(cfg, device, seed):
        # the small model's CPU init alone costs tens of seconds here
        built.append((cfg, device, seed))
        return llama.LlamaModel(cfg, device="meta", seed=None)

    monkeypatch.setattr(ent, "LlamaModel", meta_model)
    fwd, (model, tokens) = ent.entry(device="cpu")
    cfg = model.cfg
    assert built == [(llama.LlamaConfig.small(), torch.device("cpu"), 0)]
    assert callable(fwd)
    assert tuple(tokens.shape) == (8, 512) and tokens.dtype == torch.int32
    assert tokens.device == torch.device("cpu")
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(8, 512, cfg.n_heads, cfg.head_dim, generator=gen)
    kv = torch.randn(8, 512, cfg.n_kv_heads, cfg.head_dim, generator=gen)
    out = llama.default_attention(q, kv, kv)
    assert calls == [1] and tuple(out.shape) == tuple(q.shape)


def _run_chip_smoke(cwd, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_gpu():
    proc = _run_chip_smoke(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    proc = _run_chip_smoke(tmp_path, {})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_failed_nvcc_raises_with_its_output(tmp_path, monkeypatch):
    """No fallback: a compiler that fails raises with what it printed,
    and nothing is loaded."""
    from ray_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.load("paged_attention")
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    from ray_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_build_is_content_addressed():
    from ray_tpu_torch.ops import _build

    a = _build.library_path("paged_attention")
    b = _build.library_path("flash_attention")
    assert a.parent == _build.BUILD_DIR and a != b
    assert a == _build.library_path("paged_attention")
    ignored = (REPO / ".gitignore").read_text().split()
    assert "ray_tpu_torch/_build/" in ignored


# ---------------------------------------------- what the daemons spawn


def _strings(path: Path):
    """(line, text) of every string constant that is not a docstring."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            docs.add(id(node.body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.lineno, node.value


def test_no_ray_tpu_module_path_left_in_a_string():
    """The rename left no ``ray_tpu.`` module path in a string the
    runtime imports, spawns or looks up (``-m`` targets, sys.modules
    keys, import_module names)."""
    bad = [f"{p.relative_to(REPO)}:{line}: {s!r}"
           for p in sorted((REPO / "ray_tpu_torch").rglob("*.py"))
           if p.name not in ("runtime_copy.py",)
           for line, s in _strings(p)
           if re.search(r"\bray_tpu\.[A-Za-z_]", s)]
    assert bad == []


def test_daemons_spawn_the_ports_own_modules():
    """node.py starts ray_tpu_torch's head and agent, and the agent
    starts ray_tpu_torch's worker_main, all with -S and a PYTHONPATH
    that leads to this checkout (test_torch_runtime.py checks a live
    worker's argv)."""
    from ray_tpu_torch._private import spawn

    cmd, env = spawn.fast_python_cmd("ray_tpu_torch._private.worker_main")
    assert cmd[1:4] == ["-S", "-m", "ray_tpu_torch._private.worker_main"]
    assert str(REPO) in env["PYTHONPATH"].split(os.pathsep)
    agent_src = (REPO / "ray_tpu_torch" / "_private" / "node_agent.py").read_text()
    assert 'fast_python_cmd("ray_tpu_torch._private.worker_main")' \
        in agent_src
    node_src = (REPO / "ray_tpu_torch" / "_private" / "node.py").read_text()
    assert '"ray_tpu_torch._private.head"' in node_src
    assert '"ray_tpu_torch._private.node_agent"' in node_src
    assert "ray_tpu." not in agent_src.replace("ray_tpu_torch.", "")
