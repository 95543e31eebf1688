"""CPU checks of chip_smoke.py's helpers and of its refusal to run without a
GPU (the on-card phases themselves run only on the card)."""
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from dpmmsubclusters_tpu.sampler.driver import IterStats
from dpmmsubclusters_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu("cpu")
    assert exc.value.code == 2
    assert "no GPU" in capsys.readouterr().err
    chip_smoke.require_gpu("gpu")  # the card passes


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"] + args, cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _printed_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    return bool(lines) and '"ok"' in lines[-1]


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_script_fails_at_phase0_without_gpu(args):
    out = _run(args, ROOT)
    assert out.returncode != 0
    assert not _printed_result(out.stdout)


def test_script_alone_fails(tmp_path):
    """Copied away from the package, the script cannot pass."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run([], tmp_path)
    assert out.returncode != 0
    assert not _printed_result(out.stdout)


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/somewhere/jax"}, "/somewhere/jax"),
    ({}, str(compile_cache.CHECKOUT_CACHE)),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, str(compile_cache.CHECKOUT_CACHE)),
])
def test_compile_cache_dir(env, want):
    assert compile_cache.cache_dir(env) == want


def test_checkout_cache_is_in_the_checkout_and_ignored():
    assert str(compile_cache.CHECKOUT_CACHE) == os.path.join(ROOT,
                                                             ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_installed_package_sets_no_cache(tmp_path):
    """Installed under site-packages (no pyproject.toml beside the
    package), the library leaves JAX's cache unset."""
    pkg = tmp_path / "site-packages" / "dpmmsubclusters_tpu"
    pkg.mkdir(parents=True)
    assert compile_cache.checkout_cache(pkg) is None
    (tmp_path / "site-packages" / "pyproject.toml").write_text("")
    assert compile_cache.checkout_cache(pkg) == (
        tmp_path / "site-packages" / ".jax_cache")


def test_failed_child_stops_its_peers(capsys):
    """A child that dies does not leave its peers waiting: they are stopped
    after the grace period, and every failed child's log is printed."""
    import time

    py = sys.executable
    cmds = [[py, "-c", "print('peer up'); import time; time.sleep(60)"],
            [py, "-c", "import sys; print('dying'); sys.exit(3)"]]
    t0 = time.monotonic()
    with pytest.raises(chip_smoke.GateFailed, match="2 of 2"):
        chip_smoke._run_children(cmds, [dict(os.environ)] * 2, timeout=50,
                                 grace=1.0)
    assert time.monotonic() - t0 < 30
    err = capsys.readouterr().err
    assert "exited 3" in err and "dying" in err and "peer up" in err


def test_children_logs_come_back_in_order():
    py = sys.executable
    outs = chip_smoke._run_children(
        [[py, "-c", f"print({i})"] for i in range(3)],
        [dict(os.environ)] * 3, timeout=60)
    assert [o.strip() for o in outs] == ["0", "1", "2"]


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [{"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W",
     [{"name": "NVIDIA H100 80GB HBM3", "power_limit": "500.00 W"},
      {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}]),
])
def test_parse_smi(text, want):
    assert chip_smoke.parse_smi(text) == want


def test_steady_ms_takes_the_last_three_blocks():
    """The early blocks hold the tier compiles; the median of the last
    three fenced blocks is the steady state."""
    hist = IterStats.empty()
    for block_s in (30.0, 5.0, 0.32, 0.30, 0.34, 0.31):
        hist.times.extend([block_s / 16] * 16)
    assert chip_smoke.steady_ms(hist, 16) == pytest.approx(0.31 / 16 * 1e3)
