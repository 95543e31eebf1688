"""Host-side engine: compiles the sweep over a device mesh and runs the
training loop.

Replacement for the reference's orchestration layer
(``src/dp-parallel-sampling.jl``): ``run_model``'s per-iteration loop
(``:336-404``) becomes a thin host loop around ONE jitted SPMD step; all the
RPC machinery (``@spawnat``/``remotecall``/node-leader trees) is gone --
points live sharded over the mesh's ``"data"`` axis, the cluster table is
replicated, and the per-sweep O(K*S) statistics all-reduce is a ``psum``
inside the compiled program.

Scheduling semantics follow ``run_model`` exactly:
  * ``final``   = iter > iters - argmax_sample_stop   (labels by argmax)
  * ``no_more_splits`` = iter >= iters - split_stop or K >= max_clusters
(``src/dp-parallel-sampling.jl:354-361``), but both are *traced* booleans so
every iteration reuses the same executable.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..config import DPMMConfig
from ..parallel.mesh import DATA_AXIS, data_sharding, make_data_mesh, replicated
from . import assign as assign_mod
from .table import compute_posteriors, init_table
from .sweep import make_smart_pass, make_sweep


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def tier_sequence(k_max: int) -> list:
    """Capacity tiers: powers of two from 16 up to (and including) k_max."""
    tiers = []
    t = 16
    while t < k_max:
        tiers.append(t)
        t *= 2
    tiers.append(k_max)
    return tiers


def desired_tier(k_act: int, cur: int, tiers: list) -> int:
    """Pick the table capacity for the next block of sweeps.

    Grow when split headroom drops under 4x the live cluster count (splits
    can at most double K per burnout window, and capacity overflow only
    suppresses splits for a block); shrink only when capacity exceeds 16x
    (to >= 8x) so the two thresholds never flap.
    """
    k_act = max(k_act, 1)
    if 4 * k_act > cur:
        cands = [t for t in tiers if t >= 4 * k_act]
        return cands[0] if cands else tiers[-1]
    if 16 * k_act <= cur:
        cands = [t for t in tiers if t >= 8 * k_act]
        t = cands[0] if cands else tiers[-1]
        if t < cur:
            return t
    return cur


_MIGRATOR_CACHE: dict = {}


def get_migrator(family, mesh) -> "TierMigrator":
    """Process-wide TierMigrator cache: a fresh instance per fit would
    re-trace every migration program."""
    key = (family.name, tuple(d.id for d in mesh.devices.flat))
    mig = _MIGRATOR_CACHE.get(key)
    if mig is None:
        mig = TierMigrator(family, mesh)
        if len(_MIGRATOR_CACHE) > 8:
            _MIGRATOR_CACHE.clear()
        _MIGRATOR_CACHE[key] = mig
    return mig


class TierMigrator:
    """Jitted table-capacity migration: compact + resize the replicated
    table and remap the sharded labels through the slot LUT."""

    def __init__(self, family, mesh):
        from .table import retier

        def _mig(table, labels, k_new):
            table2, lut = retier(family, table, k_new)
            return table2, jnp.take(lut, labels)

        self._fn = jax.jit(
            _mig,
            static_argnums=(2,),
            out_shardings=(replicated(mesh), data_sharding(mesh)),
            donate_argnums=(1,),  # labels keep their shape; the table doesn't
        )

    def __call__(self, state: "DPMMState", k_new: int) -> "DPMMState":
        table, labels = self._fn(state.table, state.labels, k_new)
        return DPMMState(table=table, labels=labels,
                         sublabels=state.sublabels, key=state.key,
                         step=state.step)


@dataclasses.dataclass
class DPMMState:
    """The complete sampler state (a pytree of device arrays).

    Per-point streams are LANE-BLOCKED: ``[N_pad/128, 128]`` row-sharded
    over the data axis (see ``sampler.assign.block_stream``)."""

    table: Any          # replicated cluster table
    labels: jax.Array   # i32[N_pad/128, 128] sharded over data (dim 0)
    sublabels: jax.Array  # i32[N_pad/128, 128] in {0, 1}
    key: jax.Array      # replicated PRNG key
    step: int = 0


class DPMMEngine:
    """Compiled sampler for one (family, config, data-shape, mesh) tuple."""

    def __init__(self, family, cfg: DPMMConfig, mesh=None):
        self.family = family
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_data_mesh()
        self.n_dev = int(np.prod(self.mesh.devices.shape))

        sweep = make_sweep(family, cfg, axis_name=DATA_AXIS)
        self._smart_on = cfg.resolved_smart_splits(family.name)
        # the smart sub-label pass runs INSIDE the compiled block program
        # (at block end): no per-block host probe, and the marked-slot
        # lax.cond makes it free when nothing split (see
        # sweep.make_smart_pass)
        smart_fn = (
            make_smart_pass(family, cfg, axis_name=DATA_AXIS)
            if self._smart_on else None
        )

        # NOTE: the single-sweep program carries NO smart pass; the
        # per-iteration (sync) loop instead uses the host-side
        # smart_refresh probe, and the fused block runs the in-program
        # pass once per block.
        dspec, rspec = P(DATA_AXIS), P()
        self._step = jax.jit(
            shard_map(
                sweep,
                mesh=self.mesh,
                in_specs=(rspec, dspec, dspec, rspec, dspec, dspec,
                          rspec, rspec, rspec),
                out_specs=(rspec, dspec, dspec, rspec, rspec),
                check_vma=False,
            ),
            donate_argnums=(0, 1, 2, 3),
        )

        # Fused multi-sweep block: a lax.scan over sweeps inside ONE compiled
        # program.  Replaces per-iteration dispatch (each a host->device
        # round trip, like the reference's per-iteration RPC fan-out,
        # src/dp-parallel-sampling.jl:351-401) with one dispatch per block.
        # `finals`/`no_more_splits` arrive as per-sweep bool arrays computed
        # on host; the max_clusters cap is enforced in-scan from the live
        # table.
        max_k_cap = cfg.max_clusters

        def sweep_block(table, labels, sublabels, key, points, valid,
                        n_total, finals, nms):
            from .table import active_count as _ac

            def body(carry, fn):
                table, labels, sublabels, key = carry
                f, nm = fn
                if max_k_cap is not None:
                    nm = nm | (_ac(table) >= max_k_cap)
                table, labels, sublabels, key, metrics = sweep(
                    table, labels, sublabels, key, points, valid, n_total,
                    f, nm,
                )
                return (table, labels, sublabels, key), metrics

            (table, labels, sublabels, key), metrics = jax.lax.scan(
                body, (table, labels, sublabels, key), (finals, nms)
            )
            if smart_fn is not None:
                # ONE smart pass per block (not per sweep)
                table, sublabels = smart_fn(
                    table, labels, sublabels, points, valid
                )
            return table, labels, sublabels, key, metrics

        self._step_block = jax.jit(
            shard_map(
                sweep_block,
                mesh=self.mesh,
                in_specs=(rspec, dspec, dspec, rspec, dspec, dspec,
                          rspec, rspec, rspec),
                out_specs=(rspec, dspec, dspec, rspec, rspec),
                check_vma=False,
            ),
            donate_argnums=(0, 1, 2, 3),
        )

        k_max, chunk = cfg.k_max, cfg.chunk_size

        def _stats(points, valid, labels, sublabels):
            stats_lr = assign_mod.stats_only(
                points, valid, labels, sublabels, k_max, family, chunk,
                x_is_features=bool(cfg.precompute_features),
            )
            stats_lr = jax.lax.psum(stats_lr, DATA_AXIS)
            return assign_mod.lr_to_full(stats_lr)

        self._init_stats = jax.jit(
            shard_map(
                _stats,
                mesh=self.mesh,
                in_specs=(dspec, dspec, dspec, dspec),
                out_specs=rspec,
                check_vma=False,
            )
        )

        self._smart_init_cache: dict = {}
        self._smart_refresh_cache: dict = {}

        # Everything below is jitted as ONE program each: no eager per-op
        # dispatch.
        from . import moves as moves_mod

        rshard, dshard = replicated(self.mesh), data_sharding(self.mesh)

        def _build_table(key, flat3, prior, outlier_prior):
            d = (prior["m"] if "m" in prior else prior["alpha"]).shape[-1]
            table = init_table(family, prior, outlier_prior, cfg, d)
            stats = family.stats_from_flat(flat3, d)
            table = compute_posteriors(family, {**table, "stats": stats})
            # pre-sample params so the table pytree is structurally stable
            # (mirrors init_first_clusters!'s sample_clusters! at
            # src/dp-parallel-sampling.jl:76)
            return moves_mod.sample_params_step(
                key, table, cfg.alpha, cfg.outlier_mod, family
            )

        self._build_table = jax.jit(_build_table, out_shardings=rshard)

        def _rand_assign(key, n_pad: int):
            key, kl, ks, kp = jax.random.split(key, 4)
            offset = 1 if cfg.outlier_mod > 0 else 0
            shape = (n_pad // 128, 128)  # lane-blocked streams
            labels = jax.random.randint(
                kl, shape, offset, offset + cfg.init_clusters, jnp.int32
            )
            sub = jax.random.randint(ks, shape, 0, 2, jnp.int32)
            return key, kp, labels, sub

        # Outputs are born with their final shardings: no host
        # device_get/device_put roundtrip.
        self._rand_assign = jax.jit(
            _rand_assign,
            static_argnums=(1,),
            out_shardings=(rshard, rshard, dshard, dshard),
        )

    def _get_smart_init(self, d: int):
        """Lazily-built jitted smart-init program (PCA + 2-means sub-labels
        of the first clusters), keyed on the true data dim ``d`` -- with a
        precomputed feature cache the raw points are recovered from the
        cache's columns 1..D (rows are [1, x, ...])."""
        fn = self._smart_init_cache.get(d)
        if fn is not None:
            return fn
        from jax.sharding import PartitionSpec as P
        from . import smart as smart_mod

        cfg, family, k_max, chunk = self.cfg, self.family, self.cfg.k_max, \
            self.cfg.chunk_size
        x_is_features = bool(cfg.precompute_features)
        dspec, rspec = P(DATA_AXIS), P()

        def _smart(points, valid, labels, sublabels, flat3):
            raw = assign_mod.raw_points(points, d, x_is_features)
            stats = family.stats_from_flat(flat3, d)
            stats_w = jax.tree.map(lambda a: a[:, 0], stats)
            sub = smart_mod.smart_sublabels(
                raw, valid, labels, sublabels, stats_w,
                stats_w["n"] > 0, cfg.max_split_iter, DATA_AXIS,
            )
            stats_lr = jax.lax.psum(
                assign_mod.stats_only(
                    points, valid, labels, sub, k_max, family, chunk,
                    x_is_features=x_is_features,
                ),
                DATA_AXIS,
            )
            return sub, assign_mod.lr_to_full(stats_lr)

        fn = jax.jit(
            shard_map(
                _smart,
                mesh=self.mesh,
                in_specs=(dspec, dspec, dspec, dspec, rspec),
                out_specs=(dspec, rspec),
                check_vma=False,
            )
        )
        self._smart_init_cache[d] = fn
        return fn

    def _get_smart_refresh(self, d: int):
        """Jitted standalone wrapper around the SAME in-program smart pass
        the step/block programs embed (sweep.make_smart_pass) -- one
        implementation, two entry points.  Used by the host-side probe
        path (per-iteration sync loop, dryrun harness)."""
        fn = self._smart_refresh_cache.get(d)
        if fn is not None:
            return fn
        from jax.sharding import PartitionSpec as P
        from .sweep import make_smart_pass

        smart_fn = make_smart_pass(self.family, self.cfg,
                                   axis_name=DATA_AXIS)
        dspec, rspec = P(DATA_AXIS), P()

        def _refresh(table, points, valid, labels, sublabels):
            return smart_fn(table, labels, sublabels, points, valid)

        fn = jax.jit(
            shard_map(
                _refresh,
                mesh=self.mesh,
                in_specs=(rspec, dspec, dspec, dspec, dspec),
                out_specs=(rspec, dspec),
                check_vma=False,
            )
        )
        self._smart_refresh_cache[d] = fn
        return fn

    def smart_refresh(self, state: "DPMMState", points, valid) -> "DPMMState":
        """Apply the block-boundary smart sub-label pass to the slots born
        since the last call; a fast no-op (one scalar fetch) when nothing
        split and when smart splits are resolved off."""
        if not self._smart_on:
            return state
        if not hasattr(self, "_any_needs"):
            # jitted flag probe (one program, one scalar fetch)
            self._any_needs = jax.jit(jnp.any)
        if not bool(np.asarray(
            jax.device_get(self._any_needs(state.table["needs_smart"]))
        )):
            return state
        prior = state.table["prior"]
        d = (prior["m"] if "m" in prior else prior["alpha"]).shape[-1]
        table, sublabels = self._get_smart_refresh(int(d))(
            state.table, points, valid, state.labels, state.sublabels
        )
        return DPMMState(table=table, labels=state.labels,
                         sublabels=sublabels, key=state.key,
                         step=state.step)

    # -- data placement -----------------------------------------------------
    def pad_size(self, n: int) -> int:
        """Global padded row count: divisible by n_dev * chunk_size AND by
        n_dev * 128 (per-point streams are lane-blocked [N/128, 128])."""
        import math

        unit = self.n_dev * math.lcm(self.cfg.chunk_size, 128)
        return _round_up(max(n, 1), unit)

    def featurize(self, points, seed: int = 0):
        """Build the per-point feature rows ONCE (config
        ``precompute_features``); the sweep then streams [N, F_pad] instead
        of rebuilding features every sweep.  The rows are zero-padded to a
        multiple of 128 columns (assign.pad_features).

        ``seed``: folded into the bf16 stochastic-rounding key so repeated
        fits on same-shaped data don't share a correlated dither pattern
        (the noise is a pure function of (seed, global row), so it stays
        identical across process counts for a given fit)."""
        if not hasattr(self, "_featurize"):
            from .assign import pad_features

            hybrid = self.cfg.feature_dtype == "hybrid"
            if hybrid and self.family.name != "gaussian":
                raise ValueError(
                    "feature_dtype='hybrid' requires the gaussian family "
                    "(the statistics rows are rebuilt from the raw points "
                    f"by the Gaussian feature map); got family "
                    f"{self.family.name!r}"
                )
            dt = jnp.dtype(
                jnp.bfloat16 if hybrid else self.cfg.feature_dtype
            )

            def build(x, seed):
                feat = pad_features(self.family.features(x))
                if dt == jnp.bfloat16:
                    # STOCHASTIC rounding: adding uniform 16-bit noise
                    # below the bf16 mantissa before truncating makes each
                    # stored plane unbiased (round-to-nearest leaves a
                    # small correlated bias on the x_i*x_j planes).  NOTE
                    # this fixes the bias, not the variance -- the
                    # per-point noise still puts ~0.1% rms error on each
                    # cluster covariance, which nu_post amplifies into
                    # O(30)-nat Hastings noise; bf16 caches remain
                    # serving-only (see config.feature_dtype).
                    key = jax.random.fold_in(
                        jax.random.PRNGKey(0x5EED), seed
                    )
                    bits = jax.lax.bitcast_convert_type(feat, jnp.uint32)
                    r = jax.random.bits(
                        key, feat.shape, jnp.uint32
                    ) & jnp.uint32(0xFFFF)
                    rounded = jax.lax.bitcast_convert_type(
                        (bits + r) & jnp.uint32(0xFFFF0000), jnp.float32
                    ).astype(jnp.bfloat16)
                    if hybrid:
                        # bf16 cache for the ll matmul + exact raw points
                        # for the statistics rows (see
                        # config.feature_dtype)
                        return {"feat": rounded, "raw": x}
                    return rounded
                return feat.astype(dt)

            # hybrid: donate the raw points -- callers always replace them
            # with the returned cache (`points = engine.featurize(points)`)
            # and the donated buffer aliases the returned "raw" plane
            # instead of duplicating ~GBs transiently on device.  Other
            # modes' outputs can't alias (different shape), so donation
            # would only warn.
            self._featurize = jax.jit(
                build, out_shardings=data_sharding(self.mesh),
                donate_argnums=(0,) if hybrid else (),
            )
        return self._featurize(points, jnp.int32(seed))

    def shard_points(self, x: np.ndarray):
        """Pad [N, D] host points and place them sharded over the mesh.

        Returns (points, valid, n_total) device arrays.
        """
        n, d = x.shape
        n_pad = self.pad_size(n)
        xp = np.zeros((n_pad, d), np.float32)
        xp[:n] = x
        ds = data_sharding(self.mesh)
        points = jax.device_put(xp, ds)
        valid = jax.device_put(
            (np.arange(n_pad) < n).reshape(n_pad // 128, 128), ds
        )
        n_total = jax.device_put(jnp.float32(n), replicated(self.mesh))
        return points, valid, n_total

    # -- state --------------------------------------------------------------
    def init_state(self, key, points, valid, prior, outlier_prior=None,
                   init_labels: Optional[np.ndarray] = None) -> DPMMState:
        """Random first assignment + one statistics pass.

        Mirrors ``init_model_from_data`` + ``init_first_clusters!``
        (src/dp-parallel-sampling.jl:36-78): labels uniform over the
        ``init_clusters`` real slots (the outlier slot, when present, starts
        empty), sub-labels uniform over {0, 1}.
        """
        cfg = self.cfg
        n_pad = assign_mod.points_rows(points)

        key, kp, labels, sublabels = self._rand_assign(jnp.asarray(key), n_pad)
        if init_labels is not None:
            offset = 1 if cfg.outlier_mod > 0 else 0
            lp = np.full((n_pad,), offset, np.int32)
            lp[: len(init_labels)] = np.asarray(init_labels, np.int32) + offset
            labels = jax.device_put(
                lp.reshape(n_pad // 128, 128), data_sharding(self.mesh)
            )

        flat3 = self._init_stats(points, valid, labels, sublabels)
        if self._smart_on:
            # PCA + 2-means sub-label init of the first clusters (reference
            # init_first_clusters!, src/dp-parallel-sampling.jl:71-74)
            d_model = (
                prior["m"] if "m" in prior else prior["alpha"]
            ).shape[-1]
            sublabels, flat3 = self._get_smart_init(int(d_model))(
                points, valid, labels, sublabels, flat3
            )
        table = self._build_table(kp, flat3, prior, outlier_prior)
        return DPMMState(table=table, labels=labels, sublabels=sublabels,
                         key=key, step=0)

    # -- one sweep ----------------------------------------------------------
    def step(self, state: DPMMState, points, valid, n_total,
             final: bool, no_more_splits: bool):
        """Run one Gibbs sweep; returns (new_state, metrics dict of scalars)."""
        table, labels, sublabels, key, metrics = self._step(
            state.table, state.labels, state.sublabels, state.key,
            points, valid, n_total,
            jnp.asarray(final), jnp.asarray(no_more_splits),
        )
        return (
            DPMMState(table=table, labels=labels, sublabels=sublabels,
                      key=key, step=state.step + 1),
            metrics,
        )

    def step_block(self, state: DPMMState, points, valid, n_total,
                   finals: np.ndarray, no_more_splits: np.ndarray):
        """Run ``len(finals)`` fused sweeps in one dispatch; metrics arrive
        stacked [B]."""
        table, labels, sublabels, key, metrics = self._step_block(
            state.table, state.labels, state.sublabels, state.key,
            points, valid, n_total,
            jnp.asarray(finals), jnp.asarray(no_more_splits),
        )
        return (
            DPMMState(table=table, labels=labels, sublabels=sublabels,
                      key=key, step=state.step + len(finals)),
            metrics,
        )


@dataclasses.dataclass
class IterStats:
    """Per-iteration history, mirroring run_model's returned histories
    (src/dp-parallel-sampling.jl:338-344,403): cluster count, log posterior,
    wall time, and -- when ground truth is supplied -- NMI and variation of
    information (the reference records/prints both,
    src/dp-parallel-sampling.jl:370-386)."""

    k: list
    log_posterior: list
    times: list
    nmi: list
    vi: list

    @staticmethod
    def empty():
        return IterStats([], [], [], [], [])


def run_loop(
    engine: DPMMEngine,
    state: DPMMState,
    points,
    valid,
    n_total,
    iters: int,
    *,
    first_iter: int = 0,
    gt: Optional[np.ndarray] = None,
    n_valid: Optional[int] = None,
    callback: Optional[Callable] = None,
    verbose: Optional[bool] = None,
    engine_fn: Optional[Callable[[int], "DPMMEngine"]] = None,
    k_ceiling: Optional[int] = None,
) -> tuple[DPMMState, IterStats]:
    """The training loop (reference ``run_model``,
    src/dp-parallel-sampling.jl:336-404).

    ``engine_fn`` (with ``k_ceiling``) enables adaptive capacity tiers: the
    loop checks the live cluster count at block boundaries and migrates the
    table to the smallest tier with split headroom (every per-sweep cost is
    O(table width); see ``desired_tier``).  All tier decisions derive from
    the replicated K metric, so multi-process runs migrate identically.
    """
    cfg = engine.cfg
    verbose = cfg.verbose if verbose is None else verbose
    hist = IterStats.empty()
    max_k = cfg.resolved_max_clusters()
    k_now = int(np.asarray(jax.device_get(state.table["active"])).sum())

    tiers = migrator = None
    if engine_fn is not None:
        tiers = tier_sequence(k_ceiling if k_ceiling is not None else cfg.k_max)
        migrator = get_migrator(engine.family, engine.mesh)

    def tier_step(state, engine, k_now):
        cur = int(np.asarray(state.table["active"]).shape[0])
        want = desired_tier(k_now, cur, tiers)
        if want != cur:
            state = migrator(state, want)
            engine = engine_fn(want)
        return state, engine

    # Per-iteration host syncs cost a full host round trip each; only pay
    # for them when something host-side actually consumes
    # per-iteration values (verbose prints or a user callback).  Otherwise
    # run fused multi-sweep blocks -- one dispatch per `fused_block` sweeps
    # -- and fetch the metric history at the end.  Ground truth alone does
    # NOT force per-iteration syncs: NMI/VI are computed once per BLOCK
    # from the already-resident label state (each history entry repeated
    # for the block's iterations so lengths match hist.k), so long runs
    # report clustering quality without per-sweep round trips.
    # (max_clusters is enforced in-scan inside the fused block.)
    sync_each = verbose or callback is not None

    if not sync_each:
        block = max(1, cfg.fused_block)
        metrics_buf = []
        block_times = []  # (duration_s, n_sweeps) per FENCED block
        it = first_iter
        t_start = time.perf_counter()
        t_block = t_start
        while it < iters:
            b = min(block, iters - it)
            rng_it = np.arange(it, it + b)
            finals = rng_it >= iters - cfg.argmax_sample_stop
            nms = rng_it >= iters - cfg.split_stop
            state, metrics = engine.step_block(
                state, points, valid, n_total, finals, nms
            )
            metrics_buf.append(metrics)
            it += b
            fenced = False
            if gt is not None:
                # block-boundary quality metrics (one labels fetch/block).
                # The device_get IS the block fence: stamp the block time
                # right after it, BEFORE the host-side NMI/VI math, so
                # hist.times records sweep+transfer cost, not metric
                # compute (the per-iteration path excludes it the same
                # way).
                from ..utils.metrics import nmi as nmi_fn, varinfo

                labels_h = np.asarray(
                    jax.device_get(state.labels)
                ).reshape(-1)[:n_valid]
                now = time.perf_counter()
                block_times.append((now - t_block, b))
                fenced = True
                hist.nmi.extend([nmi_fn(gt, labels_h)] * b)
                hist.vi.extend([varinfo(gt, labels_h)] * b)
                t_block = time.perf_counter()
            if migrator is not None and it < iters:
                # one-scalar host sync per block; tier the next block
                # (the smart sub-label pass runs INSIDE the block program)
                k_now = int(np.asarray(jax.device_get(metrics["k"]))[-1])
                state, engine = tier_step(state, engine, k_now)
                if not fenced:
                    now = time.perf_counter()
                    block_times.append((now - t_block, b))
                    t_block = now
                fenced = True
        # hist.times in fused mode: when each block is already FENCED by a
        # host consumer (the tier probe or block NMI), per-block wall times
        # are real and recorded per block -- so medians over the tail
        # exclude compile/migration outliers (the round-4 image-seg
        # artifact's "258 ms/iter" was (loop + 5 tier compiles)/iters: a
        # compile-accounting artifact, not sweep cost).  With no per-block
        # fence the only honest number is the fenced loop mean, repeated
        # (timing async dispatches individually measures enqueue latency).
        fetched = jax.device_get(metrics_buf)
        n_done = iters - first_iter
        if len(block_times) >= max(1, (n_done // block) - 1):
            for dt_b, b in block_times:
                hist.times.extend([dt_b / b] * b)
            hist.times.extend(
                [hist.times[-1] if hist.times else 0.0]
                * (n_done - len(hist.times))
            )
        else:
            mean_t = (time.perf_counter() - t_start) / max(n_done, 1)
            hist.times.extend([mean_t] * n_done)
        for m in fetched:
            hist.k.extend(np.asarray(m["k"]).tolist())
            hist.log_posterior.extend(np.asarray(m["log_posterior"]).tolist())
        return state, hist

    for it in range(first_iter, iters):
        t0 = time.perf_counter()
        if migrator is not None:
            state, engine = tier_step(state, engine, k_now)
        if it > first_iter and it <= iters - cfg.split_stop:
            # smart init of slots born last sweep (one-scalar probe; the
            # per-iteration path already syncs every sweep).  `<=` so a
            # split accepted on the LAST split-eligible sweep still gets
            # its smart init, matching the fused-block path (which runs
            # the in-program pass after every block).
            state = engine.smart_refresh(state, points, valid)
        final = it >= iters - cfg.argmax_sample_stop
        no_more_splits = (it >= iters - cfg.split_stop) or (k_now >= max_k)
        state, metrics = engine.step(
            state, points, valid, n_total, final, no_more_splits
        )
        k_now = int(metrics["k"])  # blocks: per-iter timing fence
        dt = time.perf_counter() - t0
        hist.k.append(k_now)
        hist.log_posterior.append(float(metrics["log_posterior"]))
        hist.times.append(dt)
        if gt is not None:
            from ..utils.metrics import nmi as nmi_fn, varinfo

            labels_h = np.asarray(
                jax.device_get(state.labels)
            ).reshape(-1)[:n_valid]
            hist.nmi.append(nmi_fn(gt, labels_h))
            hist.vi.append(varinfo(gt, labels_h))
        if verbose:
            msg = (
                f"iter {it + 1}: K={k_now} "
                f"log_post={hist.log_posterior[-1]:.2f} t={dt * 1e3:.1f}ms"
            )
            if gt is not None:
                msg += f" nmi={hist.nmi[-1]:.3f} vi={hist.vi[-1]:.3f}"
            print(msg)
        if callback is not None:
            callback(it, state, metrics)
    return state, hist
