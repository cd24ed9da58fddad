"""Import hygiene of the port: ``repro_torch``, ``chip_smoke.py`` and the
tools that run its phases or time its kernels (every ``tools/*.py`` but
``physics_workflow_reference.py``, which runs the JAX package) import
neither ``jax`` nor anything of ``repro``, and the entry points never fall
back to the CPU on their own."""

import ast
import importlib.util
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import physics  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
    p for p in sorted((ROOT / "tools").glob("*.py")) if p.name != "physics_workflow_reference.py"]


PHASE_TOOL = ROOT / "tools" / "phase.py"
PHASE_NAMES = next(
    ast.literal_eval(node.value) for node in ast.parse(PHASE_TOOL.read_text()).body
    if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "PHASES")


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_files_found():
    assert len(PORT_FILES) > 20 and (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, repro_torch, repro_torch.models.physics, repro_torch.convert, "
        "repro_torch.kernels.flash_attention, repro_torch.kernels.layernorm, "
        "repro_torch.kernels.qmatmul, repro_torch.kernels.lut_softmax, "
        "repro_torch.core.streaming_mha, repro_torch.core.reuse, repro_torch.data, "
        "repro_torch.kernels.ssd_scan, repro_torch.models.lm, repro_torch.serve.kv_cache, "
        "repro_torch.serve.api, repro_torch.serve.engine, repro_torch.serve.cli, "
        "repro_torch.launch.serve, repro_torch.optim, repro_torch.train, "
        "repro_torch.checkpoint, repro_torch.data.loader, repro_torch.data.synthetic, "
        "repro_torch.kernels.flash_attention.autograd, repro_torch.kernels.layernorm.autograd, "
        "repro_torch.examples.physics_inference, repro_torch.examples.train_lm, "
        "repro_torch.models.moe, repro_torch.configs.granite_moe_3b, repro_torch.configs.dbrx_132b, "
        "repro_torch.configs.minicpm3_4b, repro_torch.models.attention, "
        "repro_torch.kernels.ssd_scan.autograd, repro_torch.distributed, "
        "repro_torch.distributed.sharding, repro_torch.distributed.collectives, "
        "repro_torch.distributed.tensor_parallel, "
        "repro_torch.launch.mesh, repro_torch.launch.train, repro_torch.launch.dryrun, "
        "repro_torch.core.latency_model, repro_torch.roofline.op_counter, "
        "repro_torch.roofline.kernel_costs, repro_torch.roofline.analysis, "
        "repro_torch.examples.quickstart, repro_torch.serve.router, "
        "repro_torch.examples.serve_lm; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gw")
    params = physics.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros(1, cfg.seq_len, cfg.input_vec_size)
    with pytest.raises(RuntimeError, match="CUDA"):
        physics.forward(params, cfg, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        physics.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": x.numpy()})
    assert physics.forward(params, cfg, x, device="cpu").shape == (1, 1)


def test_mla_entry_points_default_to_the_card(monkeypatch):
    """minicpm3-4b's caches, params and forward default to the card: without
    CUDA they raise unless asked for the CPU."""
    from repro_torch.models import lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("minicpm3-4b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_caches(cfg, 1, 8, quantized=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg, torch.Generator().manual_seed(0))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.forward(params, cfg, {"tokens": tokens})
    caches = lm.init_caches(cfg, 1, 8, torch.float32, True, device="cpu")
    last, caches = lm.prefill(params, cfg, {"tokens": tokens}, caches, device="cpu")
    assert last.shape == (1, cfg.padded_vocab_size)
    assert caches["layers"]["latent"].dtype == torch.int8


def test_entry_points_refuse_meta_outside_the_dry_run():
    """``meta`` tensors run only inside ``device.meta_trace`` (the dry run's
    and the roofline counts' own block)."""
    from repro_torch.device import meta_trace
    from repro_torch.models import lm

    cfg = get_config("granite-8b", reduced=True)
    params = lm.abstract_params(cfg)
    tokens = torch.empty(1, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        lm.forward(params, cfg, {"tokens": tokens}, device="meta")
    with meta_trace():
        logits, _, _ = lm.forward(params, cfg, {"tokens": tokens}, device="meta")
    assert logits.device.type == "meta" and logits.shape == (1, 4, cfg.padded_vocab_size)


@pytest.mark.parametrize("helper", ["exp_table", "inv_table", "rsqrt_table", "params_init"])
def test_public_helpers_default_to_cuda(monkeypatch, helper):
    from repro_torch.core import lut
    from repro_torch.models import params as params_lib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = {"w": params_lib.ArraySpec((2, 3))}
    if helper == "params_init":
        call = lambda **kw: params_lib.init_params(spec, torch.Generator().manual_seed(0), **kw)  # noqa: E731
    else:
        call = getattr(lut, helper)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    out = call(device="cpu")
    leaves = [out] if isinstance(out, torch.Tensor) else list(out.values())
    assert all(t.device.type == "cpu" for t in leaves)


def test_import_turns_tf32_off():
    code = (
        "import torch; torch.backends.cuda.matmul.allow_tf32 = True; "
        "torch.backends.cudnn.allow_tf32 = True; import repro_torch; "
        "assert not torch.backends.cuda.matmul.allow_tf32; "
        "assert not torch.backends.cudnn.allow_tf32"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


@pytest.mark.parametrize("name", PHASE_NAMES)
def test_phase_tool_names_a_phase(name):
    """Each name ``tools/phase.py`` takes is a phase of ``chip_smoke.py``
    that runs on one device argument."""
    spec = importlib.util.spec_from_file_location("_chip_smoke_under_test", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    params = list(inspect.signature(getattr(cs, f"phase_{name}")).parameters.values())
    assert params[0].name == "dev"
    assert all(p.default is not p.empty for p in params[1:])


@pytest.mark.parametrize("argv, said", [
    (["mla", "--kernels"], "no CUDA device"),
    (["mla", "--seeds", "2"], "--seeds belongs to train"),
    (["serve", "--kernels"], "no kernel cases"),
])
def test_phase_tool_stops_without_a_card_or_on_a_wrong_option(argv, said):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(PHASE_TOOL), *argv], capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 2 and said in r.stderr, (r.returncode, r.stderr[-2000:])
    assert not r.stdout
