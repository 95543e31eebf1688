"""Multi-process scaling-efficiency benchmark (CPU analog of multi-host).

Three modes:

* ``strong`` (default): fixed total workload (N points) split over P
  processes with 1 CPU device each, cross-process gloo collectives -- the
  single-machine analog of the reference's multi-machine mode and of a
  multi-GPU run (the per-sweep communication is the same ONE
  [K, 2, F] psum either way).  Efficiency = t1 / (P * tP).
* ``weak``: CONSTANT rows per process (N_total = N_per_proc * P) --
  ideal scaling keeps ms/sweep flat; efficiency = t1 / tP.  This is the
  non-core-confounded artifact BASELINE.md's >=80% target asks for (cap P
  at the machine's physical core count or the compute row is meaningless).
* ``collective``: MEASURE the per-sweep all-reduce in isolation -- psum of
  the flagship's [K, 2, F] f32 statistics block over the process mesh,
  timed per-op (bytes + latency + effective bandwidth), replacing the
  analytic "communication is microseconds" claim with a measurement.

Usage:
  python benchmarks/scaling.py [n_total] [d] [k_true] [p_list]
  python benchmarks/scaling.py --mode weak [n_per_proc] [d] [k_true] [p_list]
  python benchmarks/scaling.py --mode collective [k] [f] [p]
"""
import json
import os
import subprocess
import sys
import tempfile

_WORKER = r"""
import os, sys, json
proc, nprocs, n_total, d, k_true, port = (int(v) for v in sys.argv[1:7])
# Pin EVERY process (including the P=1 baseline) to one distinct physical
# core: XLA:CPU's intra-op thread pool otherwise grabs all cores, so the
# P=1 row would measure a multi-core baseline and every P>1 row pure core
# contention rather than scaling (the round-3 artifact's confound).
try:
    os.sched_setaffinity(0, {proc % os.cpu_count()})
except (AttributeError, OSError):
    pass
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 1)
if nprocs > 1:
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(f"localhost:{port}", nprocs, proc)
import numpy as np
import dpmmsubclusters_tpu as dpmm

rng = np.random.default_rng(0)
means = rng.standard_normal((k_true, d)).astype(np.float32) * 8.0
lab = rng.integers(0, k_true, size=n_total)
x = (means[lab] + rng.standard_normal((n_total, d)).astype(np.float32))
x_local = x[proc::nprocs]

kw = dict(alpha=10.0, iters=40, seed=3, burnout=5, k_max=32,
          track_posterior=False, verbose=False)
dpmm.fit_distributed(x_local, **kw)          # compile warmup
import time
t0 = time.perf_counter()
res = dpmm.fit_distributed(x_local, **kw)    # timed warm run
total = time.perf_counter() - t0
if proc == 0:
    print("RESULT " + json.dumps({
        "k": int(res.k),
        "ms_per_sweep": total / 40 * 1e3,
    }), flush=True)
"""


_COLLECTIVE_WORKER = r"""
import sys, json, time
proc, nprocs, k, f, port = (int(v) for v in sys.argv[1:6])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 1)
if nprocs > 1:
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(f"localhost:{port}", nprocs, proc)
import numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from dpmmsubclusters_tpu.parallel.mesh import make_data_mesh, DATA_AXIS

mesh = make_data_mesh()

def body(x, reps):
    # chain psums so none can be elided: x <- psum(x) * (1/nprocs)
    def step(c, _):
        return jax.lax.psum(c, DATA_AXIS) * (1.0 / nprocs), None
    out, _ = jax.lax.scan(step, x, None, length=reps)
    return out

from jax import shard_map
REPS = 50
fn = jax.jit(shard_map(lambda x: body(x, REPS), mesh=mesh,
                       in_specs=P(), out_specs=P(), check_vma=False))
x = jnp.ones((k, 2, f), jnp.float32)
np.asarray(fn(x))  # compile + settle
t0 = time.perf_counter()
np.asarray(fn(x))
per_op = (time.perf_counter() - t0) / REPS
if proc == 0:
    nbytes = k * 2 * f * 4
    print("RESULT " + json.dumps({
        "psum_bytes": nbytes,
        "psum_us": round(per_op * 1e6, 1),
        "effective_GB_s": round(nbytes / per_op / 1e9, 3),
        "nprocs": nprocs,
    }), flush=True)
"""


def run_collective(nprocs: int, k: int, f: int, port: int):
    with tempfile.TemporaryDirectory() as td:
        script = os.path.join(td, "cworker.py")
        with open(script, "w") as fh:
            fh.write(_COLLECTIVE_WORKER)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        )
        env.pop("JAX_PLATFORMS", None)
        procs = [
            subprocess.Popen(
                [sys.executable, script, str(i), str(nprocs), str(k),
                 str(f), str(port)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env,
            )
            for i in range(nprocs)
        ]
        outs = [p.communicate(timeout=600)[0] for p in procs]
        for i, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"proc {i}/{nprocs} failed:\n{out[-2000:]}")
        for line in outs[0].splitlines():
            if line.startswith("RESULT "):
                return json.loads(line[len("RESULT "):])
        raise RuntimeError(f"no RESULT line:\n{outs[0][-2000:]}")


def run_p(nprocs: int, n_total: int, d: int, k_true: int, port: int):
    with tempfile.TemporaryDirectory() as td:
        script = os.path.join(td, "worker.py")
        with open(script, "w") as f:
            f.write(_WORKER)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        )
        env.pop("JAX_PLATFORMS", None)
        procs = [
            subprocess.Popen(
                [sys.executable, script, str(i), str(nprocs), str(n_total),
                 str(d), str(k_true), str(port)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env,
            )
            for i in range(nprocs)
        ]
        outs = [p.communicate(timeout=1200)[0] for p in procs]
        for i, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"proc {i}/{nprocs} failed:\n{out[-2000:]}")
        for line in outs[0].splitlines():
            if line.startswith("RESULT "):
                return json.loads(line[len("RESULT "):])
        raise RuntimeError(f"no RESULT line:\n{outs[0][-2000:]}")


def main():
    args = sys.argv[1:]
    mode = "strong"
    if args and args[0] == "--mode":
        if len(args) < 2:
            raise SystemExit("--mode requires a value "
                             "(strong | weak | collective)")
        mode = args[1]
        args = args[2:]
    if mode not in ("strong", "weak", "collective"):
        raise SystemExit(f"unknown --mode {mode!r} "
                         "(strong | weak | collective)")

    if mode == "collective":
        k = int(args[0]) if len(args) > 0 else 128
        f = int(args[1]) if len(args) > 1 else 640
        p = int(args[2]) if len(args) > 2 else 2
        r = run_collective(p, k, f, 13031)
        print(json.dumps({"metric": "collective_psum", "k": k, "f": f, **r}))
        return

    n_arg = int(args[0]) if len(args) > 0 else (
        100_000 if mode == "weak" else 200_000
    )
    d = int(args[1]) if len(args) > 1 else 8
    k_true = int(args[2]) if len(args) > 2 else 8
    p_list = (
        [int(p) for p in args[3].split(",")]
        if len(args) > 3 else ([1, 2] if mode == "weak" else [1, 2, 4, 8])
    )

    rows = []
    t1 = None
    for i, p in enumerate(p_list):
        n_total = n_arg * p if mode == "weak" else n_arg
        r = run_p(p, n_total, d, k_true, 13011 + i)
        if t1 is None:
            if mode == "weak":
                t1 = r["ms_per_sweep"]
            else:
                t1 = r["ms_per_sweep"] * p  # normalize if p_list[0] != 1
        eff = (
            t1 / r["ms_per_sweep"] if mode == "weak"
            else t1 / (p * r["ms_per_sweep"])
        )
        row = {
            "metric": f"scaling_{mode}",
            "n_total": n_total, "n_per_proc": n_total // p, "d": d, "p": p,
            "ms_per_sweep": round(r["ms_per_sweep"], 2),
            "efficiency_vs_p1": round(eff, 3),
            "k": r["k"],
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "metric": f"scaling_{mode}_efficiency_table",
        "n_per_proc" if mode == "weak" else "n_total": n_arg, "d": d,
        "host_physical_cores": os.cpu_count(),
        "table": {str(r["p"]): r["efficiency_vs_p1"] for r in rows},
    }))


if __name__ == "__main__":
    main()
