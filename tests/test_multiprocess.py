"""Real multi-process fit_distributed test: 2 processes x 2 CPU devices,
cross-process collectives -- the closest single-machine analog of the
reference's ``addprocs(2)`` double-run (test/runtests.jl:8-22)."""
import os
import subprocess
import sys

import pytest

_WORKER = r"""
import sys
proc = int(sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize("localhost:12987", 2, proc)
import numpy as np
import dpmmsubclusters_tpu as dpmm

n = 1000
x = np.zeros((n, 2), np.float32)
gt = np.zeros(n, np.int64)
for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
    x[i * 250 : (i + 1) * 250] = c
    gt[i * 250 : (i + 1) * 250] = i
# each process contributes interleaved halves
x_local = x[proc::2]
res = dpmm.fit_distributed(x_local, alpha=100.0, iters=80, seed=6, burnout=5)
assert res.k == 4, res.k
assert dpmm.nmi(gt[proc::2], res.labels) > 0.999
# sharded predict + cluster_statistics must work per-process in
# multi-process programs (they mesh over jax.local_devices(); a global
# mesh here would crash on non-addressable devices)
lab_pred, _ = res.model.predict(x_local, return_probs=False)
assert dpmm.nmi(res.labels, lab_pred) > 0.999
avg_ll, avg_prob = res.model.cluster_statistics(x_local, res.labels)
assert len(avg_ll) == res.k
print(f"proc {proc}: OK K={res.k}")
"""


def _run_workers(script_path, n=2, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script_path), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True,
        )
        for i in range(n)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process run timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            if "gloo" in out.lower() or "collectives" in out.lower():
                pytest.skip(f"CPU cross-process collectives unavailable: "
                            f"{out[-500:]}")
            pytest.fail(f"proc {i} failed:\n{out[-3000:]}")
        assert f"proc {i}: OK" in out
    return outs


@pytest.mark.slow
def test_two_process_fit(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    _run_workers(script)


_SAVE_WORKER = r"""
import sys
proc = int(sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize("localhost:12991", 2, proc)
import numpy as np
import dpmmsubclusters_tpu as dpmm

n = 1000
x = np.zeros((n, 2), np.float32)
for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
    x[i * 250 : (i + 1) * 250] = c
x_local = x[proc::2]
res = dpmm.fit_distributed(
    x_local, alpha=100.0, iters=40, seed=6, burnout=5,
    enable_saving=True, model_save_interval=40,
    save_path="CKDIR/", save_file_prefix="dist_",
)
print(f"proc {proc}: OK saved K={res.k}")
"""

_RESUME_WORKER = r"""
import sys
proc = int(sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize("localhost:12993", 2, proc)
import numpy as np
import dpmmsubclusters_tpu as dpmm

n = 1000
x = np.zeros((n, 2), np.float32)
gt = np.zeros(n, np.int64)
for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
    x[i * 250 : (i + 1) * 250] = c
    gt[i * 250 : (i + 1) * 250] = i
x_local = x[proc::2]
res = dpmm.run_from_checkpoint_distributed(
    "CKDIR/dist_40.npz", x_local, iters=80,
)
assert res.model.step == 80, res.model.step
assert res.k == 4, res.k
assert dpmm.nmi(gt[proc::2], res.labels) > 0.999
print(f"proc {proc}: OK resumed K={res.k}")
"""


_RESHARD_WORKER = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
import numpy as np
import dpmmsubclusters_tpu as dpmm

n = 1000
x = np.zeros((n, 2), np.float32)
gt = np.zeros(n, np.int64)
for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
    x[i * 250 : (i + 1) * 250] = c
    gt[i * 250 : (i + 1) * 250] = i
# global row order = process-order concatenation of the 2-proc run's shards
x_all = np.concatenate([x[0::2], x[1::2]])
gt_all = np.concatenate([gt[0::2], gt[1::2]])
res = dpmm.run_from_checkpoint_distributed("CKDIR/dist_40.npz", x_all,
                                           iters=80)
assert res.model.step == 80, res.model.step
assert res.k == 4, res.k
assert dpmm.nmi(gt_all, res.labels) > 0.999
print(f"proc 0: OK resharded K={res.k}")
"""


_CLI_WORKER = r"""
import sys
proc = int(sys.argv[1])
import jax
# the CLI discovers everything from flags; platform config must happen
# before any backend use (the test harness pins JAX_PLATFORMS elsewhere)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_cpu_collectives_implementation", "gloo")
from dpmmsubclusters_tpu.run import main

main([
    "--distributed",
    "--coordinator", "localhost:12995",
    "--num-processes", "2",
    "--process-id", str(proc),
    "PARAMS",
])
print(f"proc {proc}: OK cli")
"""


class _Initialized(Exception):
    pass


@pytest.mark.parametrize("flag,want", [
    ([], None),
    (["--local-device-ids", "2"], [2]),
    (["--local-device-ids", "1,3"], [1, 3]),
])
def test_cli_passes_coordinator_and_device_ids(monkeypatch, flag, want):
    """``--distributed`` hands the coordinator flags and the process's
    local devices to ``jax.distributed.initialize``."""
    import jax

    from dpmmsubclusters_tpu.run import main

    seen = {}

    def fake_initialize(**kwargs):
        seen.update(kwargs)
        raise _Initialized

    monkeypatch.setattr(jax.distributed, "initialize", fake_initialize)
    monkeypatch.delenv("XLA_FLAGS", raising=False)  # restored afterwards
    with pytest.raises(_Initialized):
        main(["--distributed", "--coordinator", "localhost:1234",
              "--num-processes", "4", "--process-id", "2"] + flag
             + ["params.json"])
    assert seen == {"coordinator_address": "localhost:1234",
                    "num_processes": 4, "process_id": 2,
                    "local_device_ids": want}


@pytest.mark.parametrize("before,after", [
    (None, "--xla_gpu_shard_autotuning=false"),
    ("--xla_dump_to=/x", "--xla_dump_to=/x --xla_gpu_shard_autotuning=false"),
    ("--xla_gpu_shard_autotuning=true", "--xla_gpu_shard_autotuning=true"),
])
def test_multi_process_autotunes_per_process(before, after):
    """Each process autotunes its own programs unless the user chose."""
    from dpmmsubclusters_tpu.parallel.distributed import autotune_per_process

    env = {} if before is None else {"XLA_FLAGS": before}
    autotune_per_process(env)
    assert env["XLA_FLAGS"] == after


@pytest.mark.slow
def test_distributed_cli(tmp_path):
    """End-to-end ``python -m dpmmsubclusters_tpu.run --distributed``: the
    JSON params file + npy data path drive fit_distributed over 2 real
    processes (the reference's multi-machine advanced mode,
    src/dp-parallel-sampling.jl:317-334)."""
    import json

    import numpy as np

    n = 1000
    x = np.zeros((n, 2), np.float32)
    for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
        x[i * 250: (i + 1) * 250] = c
    # per-process files via the {proc} template
    np.save(tmp_path / "rows0.npy", x[0::2])
    np.save(tmp_path / "rows1.npy", x[1::2])
    params = {
        "data_path": str(tmp_path / "rows{proc}.npy"),
        "alpha": 100.0,
        "iters": 80,
        "seed": 6,
        "burnout": 5,
        "verbose": False,
    }
    ppath = tmp_path / "params.json"
    ppath.write_text(json.dumps(params))
    script = tmp_path / "cli_worker.py"
    script.write_text(_CLI_WORKER.replace("PARAMS", str(ppath)))
    outs = _run_workers(script)
    assert any("K = 4" in o for o in outs), outs[0][-500:]


@pytest.mark.slow
def test_two_process_save_kill_resume(tmp_path):
    """fit_distributed saves mid-run; fresh processes resume from the
    checkpoint and converge (reference resume semantics,
    src/dp-parallel-sampling.jl:396-401,428-447); finally a SINGLE process
    resumes the same checkpoint by globally re-sharding the label stream
    (2-proc save -> 1-proc resume -- unsupported by the reference)."""
    ckdir = str(tmp_path / "ck")
    os.makedirs(ckdir, exist_ok=True)
    save = tmp_path / "save_worker.py"
    save.write_text(_SAVE_WORKER.replace("CKDIR", ckdir))
    _run_workers(save)
    assert os.path.exists(f"{ckdir}/dist_40.npz")
    assert os.path.exists(f"{ckdir}/dist_40.npz.shard0.npz")
    assert os.path.exists(f"{ckdir}/dist_40.npz.shard1.npz")

    resume = tmp_path / "resume_worker.py"
    resume.write_text(_RESUME_WORKER.replace("CKDIR", ckdir))
    _run_workers(resume)

    reshard = tmp_path / "reshard_worker.py"
    reshard.write_text(_RESHARD_WORKER.replace("CKDIR", ckdir))
    _run_workers(reshard, n=1)
