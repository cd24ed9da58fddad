"""The port's serving CLI (``repro_torch.serve.cli``) and launcher
(``python -m repro_torch.launch.serve``).

- The shared flags build the ServeConfig the reference's CLI builds from
  the same arguments, field for field.
- The launcher answers ``--requests 4`` on the CPU at a reduced config and
  exits 0, and serves granite-moe-3b-a800m, minicpm3-4b (MLA) and
  zamba2-1.2b (hybrid; paged falls back to dense) under their own
  ``serve_policy`` (``--policy auto``: int8_serve); without
  ``--device cpu`` on a host without CUDA it raises as ``resolve_device``
  does; the flags of the async loop, speculative decoding, the victim tier,
  ``--shard-decode`` and ``--replicas`` build the reference's ServeConfig
  and serve on the CPU, each reporting its feature.
"""

import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.serve import cli as jcli  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.serve import cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--max-batch", "3", "--max-seq", "64", "--temperature", "0.5", "--policy", "auto",
        "--prefill-buckets", "8", "16", "--prefill-chunk", "8", "--decode-steps", "2",
        "--kv-layout", "paged", "--kv-page-size", "8", "--kv-pages", "20", "--kv-prefix-cache",
        "--kv-preemption", "--scheduler", "edf", "--deadline-ms", "50", "--trace-phases"]


def _parse(mod, argv):
    return mod.add_serving_args(argparse.ArgumentParser()).parse_args(argv)


@pytest.mark.parametrize("argv", [[], ARGS, ["--prefill-buckets", "--quantized"]])
def test_config_from_args_matches_reference(argv):
    ours = cli.config_from_args(_parse(cli, argv), get_config("granite-8b", reduced=True))
    ref = jcli.config_from_args(_parse(jcli, argv), jax_get_config("granite-8b", reduced=True))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert _parse(cli, argv).device == "cuda"


def test_launcher_serves_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--arch",
         "granite-8b", "--requests", "4", "--max-new", "5", "--kv-layout", "paged",
         "--kv-page-size", "8", "--stream"],
        capture_output=True, text=True, env=env, timeout=300, check=True,
    ).stdout
    assert "4 requests streamed, 20 tokens" in out
    assert "device=cpu" in out and "layout=paged" in out


def _serves_under_its_own_policy(arch, layout, capsys):
    """``--arch ARCH --policy auto``: the config's own ``serve_policy``,
    int8_serve, as the reference's CLI resolves it; the launcher serves on
    the CPU."""
    argv = ["--policy", "auto", "--kv-layout", layout, "--kv-page-size", "8"]
    ours = cli.config_from_args(_parse(cli, argv), get_config(arch, True))
    ref = jcli.config_from_args(_parse(jcli, argv), jax_get_config(arch, True))
    assert ours.policy == ref.policy == "int8_serve"
    launch.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                 "--max-new", "4", *argv])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "policy=int8_serve" in out
    assert f"layout={layout}" in out


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_launcher_serves_the_moe_family_under_its_own_policy(layout, capsys):
    """granite-moe-3b-a800m: int8 weights and KV cache, LUT softmax."""
    _serves_under_its_own_policy("granite-moe-3b-a800m", layout, capsys)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_launcher_serves_minicpm3_4b_under_its_own_policy(layout, capsys):
    """minicpm3-4b (MLA): int8 weights, the int8 latent cache, LUT softmax."""
    _serves_under_its_own_policy("minicpm3-4b", layout, capsys)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_launcher_serves_zamba2_under_its_own_policy(layout, capsys):
    """zamba2-1.2b (hybrid): int8 weights, the float shared K/V caches and
    the Mamba2 state; paged falls back to dense, as the reference's
    engine."""
    argv = ["--policy", "auto", "--kv-layout", layout, "--kv-page-size", "8"]
    ours = cli.config_from_args(_parse(cli, argv), get_config("zamba2-1.2b", True))
    ref = jcli.config_from_args(_parse(jcli, argv), jax_get_config("zamba2-1.2b", True))
    assert ours.policy == ref.policy == "int8_serve"
    launch.main(["--device", "cpu", "--arch", "zamba2-1.2b", "--requests", "3",
                 "--max-new", "4", *argv])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "policy=int8_serve" in out
    assert "layout=dense" in out and "buckets=exact" in out


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--arch", "granite-8b", "--requests", "1"])


@pytest.mark.parametrize("flags,line", [
    (["--replicas", "2"], "router: 2 replicas"),
    (["--async-loop"], "engine loop: async"),
    (["--speculative", "--spec-tokens", "3"], "speculative: draft=self k=3 | proposed"),
    (["--kv-layout", "paged", "--kv-page-size", "8", "--kv-pages", "5", "--max-seq", "32",
      "--kv-prefix-cache", "--kv-preemption", "--shared-prefix", "16", "--kv-host-pages", "8"],
     "victim tier:"),
    (["--shard-decode", "--kv-layout", "paged", "--kv-page-size", "8"], "mesh-sharded decode"),
])
def test_flags_of_this_slice_serve_on_the_cpu(flags, line, capsys):
    ours = cli.config_from_args(_parse(cli, flags), get_config("granite-8b", reduced=True))
    ref = jcli.config_from_args(_parse(jcli, flags), jax_get_config("granite-8b", reduced=True))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    launch.main(["--device", "cpu", "--requests", "4", "--max-new", "6", *flags])
    out = capsys.readouterr().out
    assert "4 requests, " in out and line in out
    if "--kv-host-pages" in flags:  # the tight pool spills and swaps back
        spills, swaps = (int(t) for t in
                         out.split("victim tier: ")[1].split(" swap-ins")[0].split(" spills / "))
        assert spills > 0 and swaps > 0
