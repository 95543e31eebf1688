#!/usr/bin/env python3
"""Bring-up check of the sampler on NVIDIA GPUs, through the user entry points.

    python chip_smoke.py                 # one card: phases 0-4
    python chip_smoke.py --four-cards    # four cards of one host: phase 5 only

Phases (one JSON line each on stdout; a failed gate raises, so the script
exits non-zero):

0. device: the default backend must be ``gpu`` (exit code 2 otherwise);
   prints the device kind and count, ``nvidia-smi``'s name and power limit,
   the JAX version, ``XLA_FLAGS`` and the compile-cache directory.
1. flagship ``dpmm.fit``: 1M x 32-d, 64 planted components, ``k_max=128``;
   gates K == 64 and NMI >= 0.99; set-up time, fenced steady ms/sweep, peak
   device memory, and the plain assign pass timed alone at the same shapes.
2. ``predict`` on the same rows (NMI >= 0.99 against the fitted labels),
   then ``save`` + ``run_from_checkpoint`` for 10 more sweeps (K >= 63).
3. multinomial ``fit`` at 50k x 100, 10 planted topics: K == 10, NMI >= 0.95.
4. the plain assign + statistics pass against a float64 NumPy reference
   (``dpmmsubclusters_tpu.utils.reference``) and the golden f64 Hastings
   vectors of ``tests/test_golden_mh.py`` at that file's tolerances.
5. (``--four-cards``) BASELINE config 5, 10M x 64-d with 100 planted
   clusters: (a) ``fit`` on a 4-card mesh against the same fit on one card
   (K equal, NMI within 0.01); (b) ``fit_distributed`` in four processes,
   each pinned to its card with ``--local-device-ids``, through
   ``python -m dpmmsubclusters_tpu.run --distributed`` with a distributed
   checkpoint and a 4-process resume; (c) a re-sharded resume of that
   checkpoint by one process over the four cards.  (b) and (c) run even
   when (a) fails; the phase fails if any part did.  The parent never opens
   a card: every JAX process of this phase is a child.

The last stdout line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

import dpmmsubclusters_tpu as dpmm
from dpmmsubclusters_tpu.utils.compile_cache import ensure_compile_cache

HERE = os.path.dirname(os.path.abspath(__file__))


class GateFailed(AssertionError):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gate(cond: bool, what: str) -> None:
    if not cond:
        raise GateFailed(what)


def smi_text() -> str:
    """``nvidia-smi``'s name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def parse_smi(text: str) -> list:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` lines ->
    [{"name": ..., "power_limit": ...}]."""
    cards = []
    for line in text.strip().splitlines():
        name, _, limit = line.rpartition(",")
        cards.append({"name": name.strip(), "power_limit": limit.strip()})
    return cards


def require_gpu(backend: str) -> None:
    """Phase 0's gate: there is no CPU fallback on this path."""
    if backend != "gpu":
        print(f"chip_smoke: no GPU (JAX default backend is {backend!r})",
              file=sys.stderr, flush=True)
        sys.exit(2)


def device_summary() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def planted_gaussian(n: int, d: int, k: int, seed: int = 0, scale=8.0):
    """``bench.py``'s recipe: separated means, unit covariances."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((k, d)).astype(np.float32) * scale
    labels = rng.integers(0, k, size=n)
    x = means[labels] + rng.standard_normal((n, d), dtype=np.float32)
    return x, labels


def steady_ms(hist, block: int) -> float:
    """Median fenced ms/sweep over the last three full fused blocks (the
    early ones hold the compiles of each table-capacity tier).  Blocks are
    fenced by the per-block NMI fetch when ``gt`` is given to ``fit``."""
    t = np.asarray(hist.times, np.float64)
    per_block = t[: len(t) // block * block].reshape(-1, block)[:, 0]
    return float(np.median(per_block[1:][-3:]) * 1e3)


def peak_bytes() -> int:
    import jax

    return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in jax.local_devices())


def time_call(fn, *args, reps: int = 10) -> float:
    """Fenced mean ms of ``fn(*args)`` after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


# rows, dims, planted components, table width, sweeps
FLAGSHIP_SHAPE = (1_000_000, 32, 64, 128, 112)
# rows, vocabulary, planted topics, trials per row (BASELINE config 2)
MNM_SHAPE = (50_000, 100, 10, 120)
# rows, dims, table width of the float64 reference check
REFERENCE_SHAPE = (65_536, 32, 128)
# rows, dims, planted clusters (BASELINE config 5)
FOUR_SHAPE = (10_000_000, 64, 100)


# --------------------------------------------------------------------------
# one card


def phase0() -> tuple:
    import jax

    cache = ensure_compile_cache()
    require_gpu(jax.default_backend())
    smi = smi_text()
    dev = device_summary()
    emit("0_device", **dev, nvidia_smi=smi, cards=parse_smi(smi),
         jax=jax.__version__, xla_flags=os.environ.get("XLA_FLAGS", ""),
         compile_cache=cache)
    return dev, smi


# The fit's seed (the data's is 0, bench.py's recipe).  Fit seed 0 ends at
# K=63 / NMI 0.9974 on the CPU (every product in full f32) and on the H100 at
# default precision, and at K=64 on the H100 with every product at
# ``highest``; seed 1 reaches K=64 in all three.  One slot keeps two
# components on the sub-cluster saddle (ROADMAP Reach 7); PERF.md holds the
# seed x precision table (benchmarks/flagship_seeds.py).
FLAGSHIP_SEED = 1


def phase1():
    import jax
    import jax.numpy as jnp

    from dpmmsubclusters_tpu.priors import GAUSSIAN
    from dpmmsubclusters_tpu.sampler import assign as A

    n, d, k_true, k_max, iters = FLAGSHIP_SHAPE
    x, gt = planted_gaussian(n, d, k_true, seed=0)
    block = dpmm.DPMMConfig().fused_block
    t0 = time.perf_counter()
    res = dpmm.fit(x, alpha=10.0, k_max=k_max, burnout=5,
                   merge_candidates=k_max, iters=iters, seed=FLAGSHIP_SEED,
                   verbose=False, gt=gt)
    wall = time.perf_counter() - t0
    nmi = dpmm.nmi(gt, res.labels)
    sweep_ms = steady_ms(res.history, block)
    loop_s = float(np.sum(res.history.times))

    # the assign + statistics pass alone, at the fit's shapes: the table
    # width the fit ended at, the featurized cache, its chunk size
    cfg = res.model.cfg
    xs = (x - res.model.shift) * res.model._scale
    table = res.model.table
    k_slots = int(np.asarray(table["active"]).shape[0])
    n_pad = -(-n // cfg.chunk_size) * cfg.chunk_size
    xp = np.zeros((n_pad, d), np.float32)
    xp[:n] = xs
    feats = jax.jit(lambda v: A.pad_features(GAUSSIAN.features(v)))(
        jnp.asarray(xp))
    valid = A.block_stream(jnp.asarray(np.arange(n_pad) < n))
    run = jax.jit(lambda key, f, v, phi, lw, lrw: A.assign_and_stats(
        key, f, v, phi, lw, lrw, jnp.asarray(False), GAUSSIAN,
        cfg.chunk_size, x_is_features=True))
    args = (jax.random.PRNGKey(0), feats, valid,
            jnp.asarray(table["params"]["phi"]),
            jnp.asarray(table["log_weights"]),
            jnp.log(jnp.maximum(jnp.asarray(table["lr_weights"]), 1e-37)))
    assign_ms = time_call(run, *args)
    emit("1_flagship_fit", n=n, d=d, k_max=k_max, iters=iters,
         k=int(res.k), nmi=nmi, wall_s=wall, setup_s=wall - loop_s,
         first_block_s=float(np.sum(res.history.times[:block])),
         steady_ms_per_sweep=sweep_ms, table_width=k_slots,
         k_per_block=res.history.k[block - 1::block],
         chunk=cfg.chunk_size, precompute_features=cfg.precompute_features,
         assign_pass_ms=assign_ms, assign_share=assign_ms / sweep_ms,
         peak_bytes=peak_bytes())
    gate(res.k == k_true, f"flagship K={res.k}, want {k_true}")
    gate(nmi >= 0.99, f"flagship NMI {nmi} < 0.99")
    return x, res


def phase2(x, res, workdir: str):
    t0 = time.perf_counter()
    pred, _ = res.predict(x)
    predict_s = time.perf_counter() - t0
    nmi_pred = dpmm.nmi(res.labels, pred)
    path = os.path.join(workdir, "flagship.npz")
    res.model.save(path)
    t0 = time.perf_counter()
    res2 = dpmm.run_from_checkpoint(path, x, iters=res.model.step + 10,
                                    verbose=False)
    resume_s = time.perf_counter() - t0
    emit("2_predict_resume", predict_s=predict_s, predict_nmi=nmi_pred,
         resume_s=resume_s, step=int(res2.model.step), k=int(res2.k))
    gate(nmi_pred >= 0.99, f"predict NMI {nmi_pred} < 0.99")
    gate(res2.model.step == res.model.step + 10, "resume step count")
    gate(res2.k >= res.k - 1, f"K={res2.k} after resume")


def phase3():
    n, d, k, trials = MNM_SHAPE
    x, gt, _ = dpmm.generate_mnmm_data(n, d, k, trials, seed=0)
    t0 = time.perf_counter()
    res = dpmm.fit(x, alpha=1.0, iters=100, seed=1, family="multinomial",
                   burnout=10, k_max=32, verbose=False)
    wall = time.perf_counter() - t0
    nmi = dpmm.nmi(gt, res.labels)
    emit("3_multinomial_fit", n=n, d=d, k=int(res.k), nmi=nmi, wall_s=wall)
    gate(res.k == k, f"multinomial K={res.k}, want {k}")
    gate(nmi >= 0.95, f"multinomial NMI {nmi} < 0.95")


# The golden f64 Hastings vectors (tests/test_golden_mh.py): each test
# function with its arguments, run in-process on the default device at that
# file's own tolerances (tests/test_gpu_card.py runs the same list).
GOLDEN_CASES = [
    ("test_log_marginal_matches_f64", (4,)),
    ("test_log_marginal_matches_f64", (16,)),
    ("test_split_log_hr_matches_f64", (4,)),
    ("test_split_log_hr_matches_f64", (16,)),
    ("test_merge_log_hr_matches_f64", (4,)),
    ("test_merge_log_hr_matches_f64", (16,)),
    ("test_padding_invariance", ()),
    ("test_forced_final_merge_rule", ()),
    ("test_screened_merge_matches_full_on_decisive_pairs", ()),
    ("test_forced_merge_tail_at_scale", ()),
]


def load_golden():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "golden_mh", os.path.join(HERE, "tests", "test_golden_mh.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def golden_mh_checks() -> dict:
    mod = load_golden()
    done = []
    for name, args in GOLDEN_CASES:
        getattr(mod, name)(*args)
        done.append(f"{name[5:]}{list(args)}")
    return {"golden_passed": done}


def phase4():
    from dpmmsubclusters_tpu.priors import GAUSSIAN, MULTINOMIAL
    from dpmmsubclusters_tpu.utils import reference as R

    n, d, k = REFERENCE_SHAPE
    chunk = min(16384, n)
    pad = n // 64  # trailing padding rows must contribute nothing
    g = R.gaussian_problem(n, d, k, k - 8, seed=0, n_valid=n - pad)
    for precompute in (True, False):
        out = R.check_problem(g, GAUSSIAN, chunk, precompute=precompute)
        emit("4_reference_gaussian", n=n, d=d, k_slots=k,
             precompute_features=precompute, **out)
        gate(out["ok"], f"gaussian reference check (precompute="
                        f"{precompute}): {out}")
    m = R.multinomial_problem(n, 100, 16, 10, seed=0, n_valid=n - pad)
    out = R.check_problem(m, MULTINOMIAL, chunk)
    emit("4_reference_multinomial", n=n, d=100, k_slots=16, **out)
    gate(out["ok"], f"multinomial reference check: {out}")
    emit("4_golden_mh", **golden_mh_checks())


def one_card() -> tuple:
    dev, smi = phase0()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        x, res = phase1()
        phase2(x, res, workdir)
        del x, res
        phase3()
        phase4()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return dev, smi


# --------------------------------------------------------------------------
# four cards: the parent stays off JAX; each JAX process is a child


FOUR_FIT = dict(alpha=10.0, seed=1, k_max=192, auto_tier=False, burnout=5,
                merge_candidates=768, track_posterior=False, verbose=False)
# sweeps of the mesh comparison (a), of the 4-process fit that saves its
# checkpoint (b), and the step the resumes run to (b, c)
FOUR_ITERS = {"fit": 80, "save": 40, "resume": 50}


def _load_four_data(data_dir: str):
    parts = [np.load(os.path.join(data_dir, f"rows{i}.npy"))
             for i in range(4)]
    return np.concatenate(parts), np.load(os.path.join(data_dir, "gt.npy"))


def child_mesh(data_dir: str) -> None:
    """(a) One process, four cards: a 4-card fit against the 1-card fit."""
    import jax

    from dpmmsubclusters_tpu.parallel.mesh import make_data_mesh

    ensure_compile_cache()
    require_gpu(jax.default_backend())
    dev = device_summary()
    gate(dev["count"] == 4, f"{dev['count']} devices, want 4")
    x, gt = _load_four_data(data_dir)
    iters = FOUR_ITERS["fit"]
    block = dpmm.DPMMConfig().fused_block
    out = {}
    for n_dev in (4, 1):
        t0 = time.perf_counter()
        res = dpmm.fit(x, mesh=make_data_mesh(n_dev), gt=gt, iters=iters,
                       **FOUR_FIT)
        out[n_dev] = {"k": int(res.k), "nmi": dpmm.nmi(gt, res.labels),
                      "wall_s": time.perf_counter() - t0,
                      "steady_ms_per_sweep": steady_ms(res.history, block)}
        del res
    emit("5a_mesh_fit", n=len(x), d=x.shape[1], iters=iters,
         cards4=out[4], cards1=out[1], peak_bytes=peak_bytes(), device=dev)
    gate(out[4]["k"] == out[1]["k"],
         f"4-card K={out[4]['k']} vs 1-card K={out[1]['k']}")
    gate(abs(out[4]["nmi"] - out[1]["nmi"]) <= 0.01, "NMI 4 vs 1 card")


def child_reshard(data_dir: str, ckpt: str) -> None:
    """(c) One process over four cards resumes the 4-process checkpoint."""
    import jax

    ensure_compile_cache()
    require_gpu(jax.default_backend())
    x, gt = _load_four_data(data_dir)
    t0 = time.perf_counter()
    res = dpmm.run_from_checkpoint_distributed(ckpt, x,
                                               iters=FOUR_ITERS["resume"])
    emit("5c_reshard_resume", k=int(res.k), step=int(res.model.step),
         nmi=dpmm.nmi(gt, res.labels), wall_s=time.perf_counter() - t0,
         device=device_summary())
    gate(res.model.step == FOUR_ITERS["resume"], "re-sharded resume step")


def _run_children(cmds: list, envs: list, timeout: float,
                  grace: float = 20.0) -> list:
    """Run the children at once and return their logs.  Once one fails, the
    others get ``grace`` seconds and are then stopped: a peer of a dead
    process would otherwise wait out the coordinator's heartbeat timeout."""
    logs = [tempfile.TemporaryFile("w+") for _ in cmds]
    procs = [subprocess.Popen(c, env=e, stdout=f, stderr=subprocess.STDOUT,
                              text=True, cwd=HERE)
             for c, e, f in zip(cmds, envs, logs)]
    end, stop = time.monotonic() + timeout, None
    try:
        while None in [p.poll() for p in procs]:  # polls every child
            now = time.monotonic()
            if stop is None and any(p.returncode for p in procs):
                stop = now + grace
            if now > end or (stop is not None and now > stop):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    failed = [(p, out) for p, out in zip(procs, outs) if p.returncode != 0]
    for p, out in failed:  # every failed child's own log, not just the first
        sys.stderr.write(f"--- child {p.args} exited {p.returncode}\n")
        sys.stderr.write(out[-6000:])
    if failed:
        raise GateFailed(f"{len(failed)} of {len(procs)} children failed")
    return outs


def _child_json(out: str, phase: str) -> dict:
    for line in out.splitlines():
        if line.startswith("{") and f'"phase": "{phase}"' in line:
            return json.loads(line)
    raise GateFailed(f"child printed no {phase} line")


def _me() -> list:
    return [sys.executable, os.path.abspath(__file__)]


def four_processes(data_dir: str) -> None:
    """(b) four processes, one card each, through the CLI: fit with a
    distributed checkpoint, a 4-process resume, then (c) the re-sharded
    resume of that checkpoint by one process over the four cards."""
    ck = os.path.join(data_dir, "ck")
    os.makedirs(ck)
    params = dict(FOUR_FIT, data_path=os.path.join(data_dir,
                                                   "rows{proc}.npy"),
                  iters=FOUR_ITERS["save"], enable_saving=True,
                  model_save_interval=FOUR_ITERS["save"], save_path=ck + "/",
                  save_file_prefix="dist_")
    ppath = os.path.join(data_dir, "params.json")
    with open(ppath, "w") as f:
        json.dump(params, f)
    port = 12000 + os.getpid() % 20000

    def launch(extra: list, port: int) -> tuple:
        # --local-device-ids pins each process to its card while every
        # card stays visible to the CUDA runtime
        cmds = [[sys.executable, "-u", "-m", "dpmmsubclusters_tpu.run",
                 "--distributed", "--coordinator", f"localhost:{port}",
                 "--num-processes", "4", "--process-id", str(i),
                 "--local-device-ids", str(i)] + extra + [ppath]
                for i in range(4)]
        t0 = time.perf_counter()
        outs = _run_children(cmds, [dict(os.environ)] * 4, 1800)
        ks = [[ln for ln in o.splitlines() if ln.startswith("K = ")]
              for o in outs]
        return ks, time.perf_counter() - t0

    ks_fit, fit_s = launch([], port)
    ckpt = os.path.join(ck, f"dist_{FOUR_ITERS['save']}.npz")
    gate(os.path.exists(ckpt), "no distributed checkpoint written")
    ks_res, res_s = launch(
        ["--resume", ckpt, "--iters", str(FOUR_ITERS["resume"])], port + 1)
    emit("5b_four_processes", fit_iters=FOUR_ITERS["save"], fit_wall_s=fit_s,
         fit_k=ks_fit, resume_iters=FOUR_ITERS["resume"],
         resume_wall_s=res_s, resume_k=ks_res)
    for ks in (ks_fit, ks_res):
        gate(all(len(v) == 1 for v in ks) and len(set(map(tuple, ks))) == 1,
             f"the four processes disagree on K: {ks}")
    k_res = int(ks_res[0][0].split("=")[1])

    out = _run_children([_me() + ["--child", "reshard", data_dir, ckpt]],
                        [dict(os.environ)], 1800)[0]
    sys.stdout.write(out)
    k_rs = _child_json(out, "5c_reshard_resume")["k"]
    gate(abs(k_rs - k_res) <= 2,
         f"re-sharded resume K={k_rs} vs 4-process resume K={k_res}")


def write_four_data(data_dir: str) -> None:
    """The 10M x 64-d planted data as four contiguous row files (the
    processes' shards, in global row order) plus the labels."""
    n, d, k = FOUR_SHAPE
    x, gt = planted_gaussian(n, d, k, seed=0)
    for i, part in enumerate(np.array_split(x, 4)):
        np.save(os.path.join(data_dir, f"rows{i}.npy"), part)
    np.save(os.path.join(data_dir, "gt.npy"), gt)


def four_cards() -> tuple:
    import jax

    from dpmmsubclusters_tpu.utils.compile_cache import cache_dir

    emit("0_device", nvidia_smi=smi_text(), jax=jax.__version__,
         xla_flags=os.environ.get("XLA_FLAGS", ""), compile_cache=cache_dir(),
         note="devices are opened by the children")
    data_dir = tempfile.mkdtemp(prefix="chip_smoke4_")
    failures, dev = [], None
    try:
        write_four_data(data_dir)
        try:  # (a) one process, four cards, against one card
            out = _run_children([_me() + ["--child", "mesh", data_dir]],
                                [dict(os.environ)], 3000)[0]
            sys.stdout.write(out)
            dev = _child_json(out, "5a_mesh_fit")["device"]
        except GateFailed as e:
            failures.append(f"5a: {e}")
        try:  # (b) and (c) run whatever (a) found
            four_processes(data_dir)
        except GateFailed as e:
            failures.append(f"5b/5c: {e}")
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    gate(not failures, "; ".join(failures))
    return dev, smi_text()


# --------------------------------------------------------------------------


def main(argv=None) -> None:
    # a SIGTERM (e.g. from `timeout`) unwinds through the finally blocks,
    # which stop the children and remove the scratch data
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phase 5 (four cards of one host) only")
    ap.add_argument("--child", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child:
        kind, rest = args.child[0], args.child[1:]
        if kind == "mesh":
            child_mesh(rest[0])
        else:
            child_reshard(rest[0], rest[1])
        return

    dev, smi = four_cards() if args.four_cards else one_card()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main()
