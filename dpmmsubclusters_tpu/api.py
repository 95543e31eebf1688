"""Public API: ``fit`` / ``predict`` / checkpointing.

Re-design of the reference's user-facing layer
(``src/dp-parallel-sampling.jl``): the four ``fit`` overloads (``:215-293``),
``dp_parallel`` (``:121``), ``run_model_from_checkpoint`` (``:428``),
``save_model`` (``:450``), ``calculate_posterior`` (``:458``), ``predict``
(``:532``) and ``cluster_statistics`` (``:509``).  Differences:

* config is one immutable :class:`~dpmmsubclusters_tpu.config.DPMMConfig`
  (no global variables, no params-file ``include``);
* data layout is ``[N, D]`` rows-as-points (the reference uses D x N);
* labels returned are 0-based dense ints;
* Gaussian data is auto-centered before sampling (the prior mean is shifted
  to match, results are shifted back) so float32 sufficient-statistic GEMMs
  stay accurate where the reference needed Float64 (``src/priors/niw.jl:46``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .config import DPMMConfig
from .priors import GAUSSIAN, MULTINOMIAL
from .parallel.mesh import make_data_mesh
from .sampler.driver import DPMMEngine, DPMMState, IterStats, run_loop
from .sampler.table import log_posterior as _table_log_posterior
from .io.checkpoint import load_checkpoint, save_checkpoint
from .utils.compile_cache import ensure_compile_cache

_FAMILIES = {"gaussian": GAUSSIAN, "multinomial": MULTINOMIAL}


def _resolve_precompute(fam, cfg: DPMMConfig, n: int, d: int,
                        n_dev: int) -> DPMMConfig:
    """Resolve ``precompute_features`` (None = auto): on for Gaussian data
    when the per-device [N_local, F] feature cache fits the budget.  Smart
    splits compose with the cache -- the raw points are recovered from the
    cache's columns 1..D (feature rows are [1, x, ...])."""
    pf = cfg.precompute_features
    if pf is None:
        # the cache is stored lane-padded (assign.pad_features) at the
        # configured storage dtype (bf16 caches are half the bytes)
        f_dim = -(-fam.feature_dim(d) // 128) * 128
        n_local = _round_up(max(n, 1), n_dev * cfg.chunk_size) // n_dev
        if cfg.feature_dtype == "hybrid":
            # bf16 cache + the raw f32 points stored alongside
            per_row = f_dim * 2 + d * 4
        else:
            per_row = f_dim * jnp.dtype(cfg.feature_dtype).itemsize
        pf = (
            fam.name == "gaussian"
            and n_local * per_row <= cfg.feature_cache_bytes
        )
    return cfg.replace(precompute_features=bool(pf))


def _tier_setup(fam, cfg: DPMMConfig, mesh, k_start: Optional[int] = None):
    """Resolve the (initial engine, engine_fn, k_ceiling) triple for adaptive
    table-capacity tiers (see sampler.driver.desired_tier); single fixed
    engine when tiering is off."""
    from .sampler.driver import desired_tier, tier_sequence

    if not cfg.resolved_auto_tier():
        return _get_engine(fam, cfg, mesh), None, None
    # a max_clusters cap bounds the useful capacity: splits are suppressed
    # at the cap, so any tier beyond the smallest one covering it is pure
    # table-width waste (every per-sweep cost grows with the table width)
    ceiling = cfg.k_max
    if cfg.max_clusters is not None:
        need = int(cfg.max_clusters) + (1 if cfg.outlier_mod > 0 else 0)
        fits = [t for t in tier_sequence(cfg.k_max) if t >= need]
        if fits:
            ceiling = min(ceiling, fits[0])
    tiers = tier_sequence(ceiling)
    if k_start is None:
        init_active = cfg.init_clusters + (1 if cfg.outlier_mod > 0 else 0)
        k_start = min(desired_tier(init_active, tiers[0], tiers), ceiling)
    # an explicit k_start (checkpointed table width) must NOT be clamped:
    # the starting engine has to match the loaded table; the tier loop
    # migrates it toward the ceiling on the first block boundary
    engine = _get_engine(fam, cfg.replace(k_max=int(k_start)), mesh)
    return (
        engine,
        lambda k: _get_engine(fam, cfg.replace(k_max=int(k)), mesh),
        ceiling,
    )

# Engines are cached per (family, config, mesh): each DPMMEngine owns fresh
# jit closures, so rebuilding one per fit() call would retrace every
# compiled program.
_ENGINE_CACHE: dict = {}


def _get_engine(fam, cfg: DPMMConfig, mesh) -> DPMMEngine:
    key = (fam.name, cfg, tuple(d.id for d in mesh.devices.flat))
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        ensure_compile_cache()
        eng = DPMMEngine(fam, cfg, mesh)
        if len(_ENGINE_CACHE) > 8:
            _ENGINE_CACHE.clear()
        _ENGINE_CACHE[key] = eng
    return eng


_PRIOR_KEYS = {
    "gaussian": ("kappa", "m", "nu", "psi"),
    "multinomial": ("alpha",),
}


def _validate_prior(fam, prior: dict, d: int, name: str = "prior") -> dict:
    """Check a user prior dict's keys and shapes against the family and the
    data dimension, returning the converted float32 pytree.  A typo'd key or
    a wrong-D array otherwise either silently becomes an extra array or
    fails deep inside jit with an opaque shape error."""
    want = _PRIOR_KEYS[fam.name]
    got = set(prior)
    if got != set(want):
        raise ValueError(
            f"{name} for the {fam.name} family must have exactly the keys "
            f"{list(want)}; got {sorted(got)}"
        )
    out = {k: jnp.asarray(v, jnp.float32) for k, v in prior.items()}
    shapes = (
        {"kappa": (), "m": (d,), "nu": (), "psi": (d, d)}
        if fam.name == "gaussian"
        else {"alpha": (d,)}
    )
    for k, shape in shapes.items():
        if out[k].shape != shape:
            raise ValueError(
                f"{name}[{k!r}] must have shape {shape} for D={d} data; "
                f"got {tuple(out[k].shape)}"
            )
    if fam.name == "gaussian":
        if not float(out["kappa"]) > 0:
            raise ValueError(f"{name}['kappa'] must be > 0")
        if not float(out["nu"]) > d - 1:
            raise ValueError(
                f"{name}['nu'] must be > D-1={d - 1} for a proper NIW "
                f"prior; got {float(out['nu'])}"
            )
    return out


def _resolve_family(family, prior):
    if family is None:
        if prior is not None and "alpha" in prior:
            return MULTINOMIAL
        return GAUSSIAN
    if isinstance(family, str):
        return _FAMILIES[family]
    return family


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _effective_chunk(cfg: DPMMConfig, n: int, n_dev: int) -> int:
    """Per-device scan chunk: a multiple of 512 (and so of the 128-row
    blocks of the per-point streams)."""
    per_dev = -(-n // n_dev)
    return max(
        512, min(_round_up(cfg.chunk_size, 512), _round_up(per_dev, 512))
    )


_ROW_PROGRAM_CACHE: dict = {}


def _run_sharded_rows(key, build, chunk, row_arrays, rep_args, n_out):
    """Shared machinery for row-parallel model evaluations (predict,
    cluster_statistics): pad + shard the row arrays over THIS process's
    devices, run a cached jitted shard_map of ``build(chunk)`` (a fresh
    jit per call would retrace/recompile every invocation), return device
    outputs.

    ``row_arrays``: host arrays sharded over rows (first dim N, padded
    with zeros / -1 for ints).  ``rep_args``: replicated device operands.
    The mesh uses ``jax.local_devices()`` -- in multi-process programs
    each process evaluates its own rows (row-parallel; the global mesh's
    non-addressable devices cannot be fed from local host arrays).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from .parallel.mesh import DATA_AXIS, data_sharding, make_data_mesh

    mesh = make_data_mesh(devices=jax.local_devices())
    n = len(row_arrays[0])
    n_dev = int(np.prod(mesh.devices.shape))
    chunk = max(128, min(chunk, _round_up(-(-n // n_dev), 128)))
    n_pad = _round_up(n, n_dev * chunk)
    padded = []
    for a in row_arrays:
        fill = -1 if np.issubdtype(a.dtype, np.integer) else 0
        ap = np.full((n_pad,) + a.shape[1:], fill, a.dtype)
        ap[:n] = a
        padded.append(jax.device_put(ap, data_sharding(mesh)))

    cache_key = key + (chunk, n_pad, n_dev,
                       tuple(d.id for d in mesh.devices.flat))
    fn = _ROW_PROGRAM_CACHE.get(cache_key)
    if fn is None:
        row_spec = (P(DATA_AXIS),) * len(row_arrays)
        fn = jax.jit(shard_map(
            build(chunk), mesh=mesh,
            in_specs=row_spec + (P(),) * len(rep_args),
            out_specs=(P(DATA_AXIS),) * n_out if n_out > 1 else P(),
            check_vma=False,
        ))
        if len(_ROW_PROGRAM_CACHE) > 32:
            _ROW_PROGRAM_CACHE.clear()
        _ROW_PROGRAM_CACHE[cache_key] = fn
    return fn(*padded, *rep_args)


@dataclasses.dataclass
class DPMMModel:
    """A fitted (or checkpointed) model: everything needed for prediction,
    posterior evaluation, and resuming."""

    family: Any
    table: Any                  # host pytree (cluster table)
    shift: np.ndarray           # centering shift applied to the data
    cfg: DPMMConfig
    n_points: int
    labels_raw: np.ndarray      # slot-id labels, [n_points]
    sublabels: np.ndarray       # {0,1}, [n_points]
    key: np.ndarray
    step: int = 0
    scale: Optional[np.ndarray] = None  # per-dim standardization factors
    # (x' = scale * (x - shift)); None = ones (pre-standardization ckpts)

    @property
    def _scale(self) -> np.ndarray:
        if self.scale is None:
            return np.ones_like(self.shift)
        return self.scale

    # -- exports ------------------------------------------------------------
    @property
    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(np.asarray(self.table["active"]))

    @property
    def k(self) -> int:
        return len(self.active_slots)

    @property
    def labels(self) -> np.ndarray:
        """Dense 0-based labels."""
        k_max = np.asarray(self.table["active"]).shape[0]
        lut = np.zeros(k_max, np.int32)
        lut[self.active_slots] = np.arange(self.k, dtype=np.int32)
        return lut[self.labels_raw]

    @property
    def weights(self) -> np.ndarray:
        """Sampled mixture weights of the active clusters (dense order)."""
        w = np.exp(np.asarray(self.table["log_weights"], np.float64))
        return w[self.active_slots]

    @property
    def counts(self) -> np.ndarray:
        return np.asarray(self.table["stats"]["n"])[self.active_slots, 0]

    def cluster_params(self) -> list:
        """Per-cluster dict of posterior hyperparams (+ sampled params),
        mapped back to the original data space (de-standardized and
        de-centered)."""
        out = []
        shift, s = self.shift, self._scale
        weights = self.weights  # dense order, aligned with active_slots
        for dense_i, slot in enumerate(self.active_slots):
            post = {
                k: np.asarray(v)[slot, 0]
                for k, v in self.table["post"].items()
            }
            entry = {"slot": int(slot), "posterior": post}
            if "m" in post:
                post["m"] = post["m"] / s + shift
                if "psi" in post:
                    post["psi"] = post["psi"] / (s[:, None] * s[None, :])
                params = self.table["params"]
                entry["mu"] = np.asarray(params["mu"])[slot, 0] / s + shift
                prec = np.asarray(params["prec"])[slot, 0]
                entry["cov"] = np.linalg.inv(prec) / (s[:, None] * s[None, :])
            else:
                params = self.table["params"]
                entry["log_p"] = np.asarray(params["log_p"])[slot, 0]
            entry["weight"] = weights[dense_i]
            out.append(entry)
        return out

    # -- prediction (reference predict / predict_points,
    #    src/dp-parallel-sampling.jl:532-537, local_clusters_actions.jl:23-40)
    def predict(self, x: np.ndarray, return_probs: bool = True,
                chunk: int = 1 << 16):
        """Posterior-predictive hard assignment of new points.

        Returns (labels i32[N] dense 0-based, probs f32[N, K]); with
        ``return_probs=False`` probs is None (skips the [N, K] host
        transfer -- the right call at 10M-point scale).

        Unlike the reference's master-only ``predict_points``
        (src/local_clusters_actions.jl:23-40), rows are SHARDED over this
        process's device mesh and evaluated in ``chunk``-row tiles per
        device, so the [N, K] matrix never materializes beyond one tile
        per device.  In multi-process programs each process predicts its
        own rows on its own devices (the work is row-parallel; no
        collective needed).
        """
        x = (np.asarray(x, np.float32) - self.shift) * self._scale
        slots = self.active_slots
        post = jax.tree.map(
            lambda a: np.asarray(a)[slots, 0], self.table["post"]
        )
        w = self.counts + self.cfg.alpha
        log_w = np.log(w / w.sum()).astype(np.float32)
        family, ret_probs = self.family, bool(return_probs)

        def build(chunk):
            def _pred(xs, post, log_w):
                def body(_, xc):
                    logits = family.posterior_predictive(xc, post) + log_w
                    lab = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                    if ret_probs:
                        z = jnp.exp(
                            logits - logits.max(axis=-1, keepdims=True)
                        )
                        pr = (z / z.sum(axis=-1, keepdims=True)).astype(
                            jnp.float32
                        )
                    else:
                        pr = jnp.zeros((xc.shape[0], 0), jnp.float32)
                    return None, (lab, pr)

                _, (lab, pr) = jax.lax.scan(
                    body, None, xs.reshape((-1, chunk) + xs.shape[1:])
                )
                return (lab.reshape(-1),
                        pr.reshape(xs.shape[0], pr.shape[-1]))

            return _pred

        n = len(x)
        lab_dev, pr_dev = _run_sharded_rows(
            ("predict", family.name, len(slots), x.shape[1], ret_probs),
            build, chunk, (x,),
            (jax.tree.map(jnp.asarray, post), jnp.asarray(log_w)),
            n_out=2,
        )
        labels = np.asarray(jax.device_get(lab_dev))[:n]
        probs = (
            np.asarray(jax.device_get(pr_dev))[:n] if ret_probs else None
        )
        return labels, probs

    def log_posterior(self) -> float:
        """DP-CRP + marginal-likelihood log posterior
        (reference ``calculate_posterior``, src/dp-parallel-sampling.jl:458-470)."""
        fn = jax.jit(
            lambda table: _table_log_posterior(
                self.family, table, self.cfg.alpha, float(self.n_points)
            )
        )
        # constant change-of-variables term mapping the standardized-space
        # marginals back to the data space (n * sum(log scale))
        return float(fn(self.table)) + self.n_points * float(
            np.log(self._scale).sum()
        )

    def cluster_statistics(self, x: np.ndarray, labels: np.ndarray,
                           chunk: int = 1 << 16):
        """Average per-cluster log-likelihood and responsibility of ``x``
        under the *sampled* cluster distributions (reference
        ``cluster_statistics``, src/dp-parallel-sampling.jl:509-530 -- with
        the correct Gaussian normalizer, see SURVEY.md L2 bug note).
        Log-likelihoods are reported in the original data space (the
        standardized-space values shift by the constant sum(log scale)).

        Rows are sharded over this process's device mesh and reduced in
        chunked tiles (like :meth:`predict`): the [N, K] matrix never
        materializes, so this works at 10M-point scale."""
        from .parallel.mesh import DATA_AXIS

        x = (np.asarray(x, np.float32) - self.shift) * self._scale
        slots = self.active_slots
        k = len(slots)
        phi = np.asarray(self.table["params"]["phi"])[slots, 0]
        family = self.family

        def build(chunk):
            def _stats(xs, ls, ph):
                def body(acc, inp):
                    xc, lc = inp
                    ll = family.features(xc) @ ph.T          # [C, K]
                    z = jnp.exp(ll - ll.max(axis=-1, keepdims=True))
                    resp = z / z.sum(axis=-1, keepdims=True)
                    oh = jax.nn.one_hot(lc, k, dtype=jnp.float32)  # -1 -> 0
                    return (
                        acc[0] + jnp.sum(oh * ll, axis=0),
                        acc[1] + jnp.sum(oh * resp, axis=0),
                        acc[2] + jnp.sum(oh, axis=0),
                    ), None

                acc0 = (jnp.zeros((k,)), jnp.zeros((k,)), jnp.zeros((k,)))
                (s_ll, s_resp, cnt), _ = jax.lax.scan(
                    body, acc0,
                    (xs.reshape((-1, chunk) + xs.shape[1:]),
                     ls.reshape(-1, chunk)),
                )
                return jax.lax.psum(
                    jnp.stack([s_ll, s_resp, cnt]), DATA_AXIS
                )

            return _stats

        out = _run_sharded_rows(
            ("cluster_statistics", family.name, k, x.shape[1]),
            build, chunk, (x, np.asarray(labels, np.int32)),
            (jnp.asarray(phi),), n_out=1,
        )
        s_ll, s_resp, cnt = np.asarray(jax.device_get(out), np.float64)
        cnt = np.maximum(cnt, 1.0)
        # density change of variables back to data space: p_data = p' * |s|
        avg_ll = s_ll / cnt + float(np.log(self._scale).sum())
        avg_prob = s_resp / cnt
        return avg_ll, avg_prob

    # -- persistence ----------------------------------------------------------
    def save(self, path: str):
        save_checkpoint(
            path,
            table=self.table,
            labels=self.labels_raw,
            sublabels=self.sublabels,
            key=self.key,
            step=self.step,
            shift=self.shift,
            cfg=self.cfg,
            family_name=self.family.name,
            n_points=self.n_points,
            scale=self.scale,
        )


@dataclasses.dataclass
class FitResult:
    """What ``fit`` returns (counterpart of the reference's 9-tuple,
    src/dp-parallel-sampling.jl:218)."""

    model: DPMMModel
    history: IterStats

    # convenience mirrors of the reference tuple
    @property
    def labels(self):
        return self.model.labels

    @property
    def weights(self):
        return self.model.weights

    @property
    def k(self):
        return self.model.k

    def predict(self, x):
        return self.model.predict(x)


def _prepare_data(data, transposed: bool) -> np.ndarray:
    x = np.asarray(data, np.float32)
    if x.ndim != 2:
        raise ValueError(f"data must be 2-D, got shape {x.shape}")
    if transposed:
        x = x.T
    return np.ascontiguousarray(x)


def fit(
    data,
    alpha: float = 10.0,
    prior: Optional[dict] = None,
    *,
    family=None,
    gt=None,
    mesh=None,
    n_devices: Optional[int] = None,
    outlier_prior: Optional[dict] = None,
    transposed: bool = False,
    config: Optional[DPMMConfig] = None,
    **overrides,
) -> FitResult:
    """Fit a DPMM with the sub-cluster split/merge sampler.

    Counterpart of the reference ``fit`` overloads
    (src/dp-parallel-sampling.jl:215-293): ``prior=None`` uses the weak
    default NIW(1, 0, D+3, I) prior (``:270-277``).  ``data`` is [N, D]
    (``transposed=True`` accepts the reference's D x N layout).  Any
    :class:`DPMMConfig` field can be passed as a keyword override.
    """
    x = _prepare_data(data, transposed)
    n, d = x.shape

    cfg = config if config is not None else DPMMConfig()
    if alpha is not None:
        overrides.setdefault("alpha", float(alpha))
    if overrides:
        cfg = cfg.replace(**overrides)

    fam = _resolve_family(family, prior)
    if prior is None:
        # the weak default NIW(1, 0, D+3, I) is stated in DATA space, like
        # the reference's (src/dp-parallel-sampling.jl:270-277), and is
        # transformed below exactly like a user prior -- standardization is
        # a pure numerical transform with zero model footprint
        prior = fam.default_prior(d)
    else:
        prior = _validate_prior(fam, prior, d)

    if mesh is None:
        mesh = make_data_mesh(n_devices)
    n_dev = int(np.prod(mesh.devices.shape))
    cfg = cfg.replace(chunk_size=_effective_chunk(cfg, n, n_dev))

    # auto-centering + standardization (gaussian only): centering keeps the
    # f32 sum_xx accurate; per-dim standardization keeps the posterior
    # scatter well-conditioned so the f32 Cholesky/logdet chain stays
    # faithful (see DPMMConfig.standardize_data).  Both are exact model
    # transforms -- the prior (user or default, both stated in data space)
    # is mapped along and results mapped back.
    shift = np.zeros(d, np.float32)
    scale = np.ones(d, np.float32)
    if fam.name == "gaussian":
        if outlier_prior is not None:
            outlier_prior = _validate_prior(fam, outlier_prior, d,
                                            name="outlier_prior")
        if cfg.center_data:
            shift = x.mean(axis=0)
            x = x - shift
            prior = fam.shift_prior(prior, -jnp.asarray(shift))
            if outlier_prior is not None:
                outlier_prior = fam.shift_prior(
                    outlier_prior, -jnp.asarray(shift)
                )
        if cfg.standardize_data:
            sd = x.std(axis=0)
            scale = np.where(sd > 1e-12, 1.0 / sd, 1.0).astype(np.float32)
            x = x * scale
            prior = fam.scale_prior(prior, scale)
            if outlier_prior is not None:
                outlier_prior = fam.scale_prior(outlier_prior, scale)

    cfg = _resolve_precompute(fam, cfg, n, d, n_dev)
    engine, engine_fn, k_ceiling = _tier_setup(fam, cfg, mesh)
    points, valid, n_total = engine.shard_points(x)
    seed = cfg.seed if cfg.seed is not None else np.random.randint(0, 2**31 - 1)
    if cfg.precompute_features:
        points = engine.featurize(points, seed=seed)
    key = jax.random.PRNGKey(seed)
    state = engine.init_state(key, points, valid, prior, outlier_prior)

    callback = None
    if cfg.enable_saving:
        def callback(it, st, _metrics):
            if (it + 1) % cfg.model_save_interval == 0:
                _model_from_state(fam, cfg, st, shift, n, scale).save(
                    f"{cfg.save_path}{cfg.save_file_prefix}{it + 1}.npz"
                )

    state, hist = run_loop(
        engine, state, points, valid, n_total, cfg.iters,
        gt=np.asarray(gt) if gt is not None else None,
        n_valid=n, callback=callback,
        engine_fn=engine_fn, k_ceiling=k_ceiling,
    )
    model = _model_from_state(fam, cfg, state, shift, n, scale)
    return FitResult(model=model, history=hist)


def _model_from_state(fam, cfg, state: DPMMState, shift, n: int,
                      scale=None) -> DPMMModel:
    table = jax.tree.map(lambda a: np.asarray(jax.device_get(a)), state.table)
    return DPMMModel(
        family=fam,
        table=table,
        shift=np.asarray(shift, np.float32),
        cfg=cfg,
        n_points=n,
        labels_raw=np.asarray(jax.device_get(state.labels)).reshape(-1)[:n],
        sublabels=np.asarray(jax.device_get(state.sublabels)).reshape(-1)[:n],
        key=np.asarray(jax.device_get(state.key)),
        step=state.step,
        scale=None if scale is None else np.asarray(scale, np.float32),
    )


def fit_distributed(
    x_local,
    alpha: float = 10.0,
    prior: Optional[dict] = None,
    *,
    family=None,
    outlier_prior: Optional[dict] = None,
    config: Optional[DPMMConfig] = None,
    **overrides,
) -> FitResult:
    """Multi-host ``fit``: every process passes only ITS rows.

    Counterpart of the reference's multi-machine mode (user-level
    ``addprocs`` + ``DistributedArrays.distribute``,
    ``docs/src/perf.md:3``, ``src/dp-parallel-sampling.jl:42``).  Call
    ``parallel.distributed.initialize()`` first on every process; the global
    mesh spans all devices of all processes and the per-sweep statistics
    ``psum`` is the only cross-process collective.  The returned model's
    ``labels`` cover THIS process's rows only (the table and all cluster
    parameters are global and identical on every process).
    """
    from .parallel import distributed as dist

    x = np.ascontiguousarray(np.asarray(x_local, np.float32))
    n_local, d = x.shape
    cfg = config if config is not None else DPMMConfig()
    if alpha is not None:
        overrides.setdefault("alpha", float(alpha))
    if overrides:
        cfg = cfg.replace(**overrides)
    fam = _resolve_family(family, prior)
    if prior is None:
        prior = fam.default_prior(d)
    else:
        prior = _validate_prior(fam, prior, d)

    mesh = dist.global_data_mesh()
    n_dev = int(np.prod(mesh.devices.shape))
    cfg = cfg.replace(
        chunk_size=_effective_chunk(cfg, max(n_local, 1) * jax.process_count(),
                                    n_dev)
    )
    cfg = _resolve_precompute(
        fam, cfg, max(n_local, 1) * jax.process_count(), d, n_dev
    )
    engine, engine_fn, k_ceiling = _tier_setup(fam, cfg, mesh)
    points, valid, n_global = dist.shard_points_global(
        x, mesh, cfg.chunk_size
    )

    # global centering + standardization (gaussian): masked moments over
    # every process's rows, one psum'd program (see fit() for why)
    shift = np.zeros(d, np.float32)
    scale = np.ones(d, np.float32)
    if fam.name == "gaussian" and (cfg.center_data or cfg.standardize_data):
        from jax.sharding import NamedSharding, PartitionSpec as P

        rsh = NamedSharding(mesh, P())
        sums = jax.jit(
            lambda p, v: (
                jnp.sum(p * v.reshape(-1)[:, None], axis=0),
                jnp.sum(v.astype(jnp.float32)),
            ),
            out_shardings=rsh,
        )(points, valid)
        s1 = np.asarray(jax.device_get(sums[0]), np.float64)
        cnt = max(float(jax.device_get(sums[1])), 1.0)
        mean = (s1 / cnt).astype(np.float32)
        # TWO-PASS variance: psum the mean first, then psum squared
        # deviations.  The raw-moment difference E[x^2] - E[x]^2 in f32
        # cancels catastrophically when |mean| >> sd (large coordinate
        # offsets -- exactly the regime standardize_data exists for) and
        # would silently clamp to scale=1.
        s2c = np.asarray(jax.device_get(jax.jit(
            lambda p, v, mu: jnp.sum(
                jnp.square(p - mu) * v.reshape(-1)[:, None], axis=0
            ),
            out_shardings=rsh,
        )(points, valid, jnp.asarray(mean))), np.float64)
        if outlier_prior is not None:
            outlier_prior = _validate_prior(fam, outlier_prior, d,
                                            name="outlier_prior")
        if cfg.center_data:
            shift = mean
            prior = fam.shift_prior(prior, -jnp.asarray(shift))
            if outlier_prior is not None:
                outlier_prior = fam.shift_prior(
                    outlier_prior, -jnp.asarray(shift)
                )
        if cfg.standardize_data:
            var = np.maximum(s2c / cnt, 0.0)  # pass was valid-masked
            sd = np.sqrt(var)
            scale = np.where(sd > 1e-12, 1.0 / sd, 1.0).astype(np.float32)
            prior = fam.scale_prior(prior, scale)
            if outlier_prior is not None:
                outlier_prior = fam.scale_prior(outlier_prior, scale)
        points = jax.jit(
            lambda p, v: (p - (
                jnp.asarray(shift) * v.reshape(-1)[:, None].astype(p.dtype)
            )) * jnp.asarray(scale),
            out_shardings=points.sharding,
            donate_argnums=(0,),
        )(points, valid)

    seed = cfg.seed if cfg.seed is not None else 0
    if cfg.precompute_features:
        points = engine.featurize(points, seed=seed)
    state = engine.init_state(
        jax.random.PRNGKey(seed), points, valid, prior, outlier_prior
    )
    n_total = jax.device_put(
        jnp.float32(n_global),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()),
    )
    callback = _distributed_save_callback(fam, cfg, shift, n_global, n_local,
                                          scale)
    state, hist = run_loop(
        engine, state, points, valid, n_total, cfg.iters, verbose=False,
        callback=callback, engine_fn=engine_fn, k_ceiling=k_ceiling,
    )

    table = jax.tree.map(lambda a: np.asarray(jax.device_get(a)), state.table)
    labels_local = np.concatenate(
        [np.asarray(s.data) for s in state.labels.addressable_shards]
    ).reshape(-1)[:n_local]
    sub_local = np.concatenate(
        [np.asarray(s.data) for s in state.sublabels.addressable_shards]
    ).reshape(-1)[:n_local]
    model = DPMMModel(
        family=fam, table=table, shift=np.asarray(shift, np.float32),
        cfg=cfg, n_points=int(n_global), labels_raw=labels_local,
        sublabels=sub_local,
        key=np.asarray(jax.device_get(state.key)), step=state.step,
        scale=np.asarray(scale, np.float32),
    )
    return FitResult(model=model, history=hist)


def _distributed_save_callback(fam, cfg: DPMMConfig, shift, n_global,
                               n_local, scale=None):
    """Periodic multi-process checkpoint writer (``cfg.enable_saving``):
    process 0 writes the master table file, every process its label shard
    (reference saves from every mode, src/dp-parallel-sampling.jl:396-401)."""
    if not cfg.enable_saving:
        return None
    from .io.checkpoint import save_checkpoint_distributed

    def callback(it, st, _metrics):
        if (it + 1) % cfg.model_save_interval == 0:
            save_checkpoint_distributed(
                f"{cfg.save_path}{cfg.save_file_prefix}{it + 1}.npz",
                table=st.table, labels=st.labels, sublabels=st.sublabels,
                key=st.key, step=it + 1, shift=shift, cfg=cfg,
                family_name=fam.name, n_points_global=int(n_global),
                n_local=n_local, scale=scale,
            )

    return callback


def run_from_checkpoint_distributed(
    path: str,
    x_local,
    *,
    iters: Optional[int] = None,
    **overrides,
) -> FitResult:
    """Resume a ``fit_distributed`` run.  Every process passes its local
    rows; the global row order (concatenation over process index) must
    match the original run's, but the process COUNT and the per-process
    row partition may differ -- labels are globally re-sharded onto the new
    grid (the reference refuses this; its ``run_model_from_checkpoint``
    re-distributes over the same worker set,
    src/dp-parallel-sampling.jl:428-447)."""
    from .parallel import distributed as dist
    from .parallel.mesh import data_sharding, replicated
    from .io.checkpoint import load_checkpoint_distributed

    x = np.ascontiguousarray(np.asarray(x_local, np.float32))
    n_local, d = x.shape
    ck, shard = load_checkpoint_distributed(path, n_local=n_local)
    cfg: DPMMConfig = ck["config"]
    if iters is not None:
        overrides["iters"] = iters
    if overrides:
        cfg = cfg.replace(**overrides)
    fam = _FAMILIES[ck["family"]]

    if n_local != shard["n_local"]:
        raise ValueError(
            f"checkpoint shard holds {shard['n_local']} rows, got {n_local}"
        )
    shift = np.asarray(ck["shift"], np.float32)
    scale = (np.ones(d, np.float32) if ck.get("scale") is None
             else np.asarray(ck["scale"], np.float32))

    mesh = dist.global_data_mesh()
    n_dev = int(np.prod(mesh.devices.shape))
    n_est = max(n_local, 1) * jax.process_count()
    cfg = cfg.replace(chunk_size=_effective_chunk(cfg, n_est, n_dev))
    cfg = _resolve_precompute(fam, cfg, n_est, d, n_dev)
    k_saved = int(np.asarray(ck["table"]["active"]).shape[0])
    engine, engine_fn, k_ceiling = _tier_setup(fam, cfg, mesh, k_start=k_saved)

    points, valid, n_global = dist.shard_points_global(
        (x - shift) * scale, mesh, cfg.chunk_size
    )
    if cfg.precompute_features:
        # bf16 dither key: match the original fit when it was seeded (an
        # unseeded bf16 resume redraws the -- unbiased -- dither)
        points = engine.featurize(
            points, seed=cfg.seed if cfg.seed is not None else 0
        )
    # this process's padded row count (same formula as shard_points_global)
    import math

    mult = jax.local_device_count() * math.lcm(cfg.chunk_size, 128)
    n_local_pad = ((max(n_local, 1) + mult - 1) // mult) * mult

    def _pad_local_i32(a, fill):
        out = np.full((n_local_pad,), fill, np.int32)
        out[:n_local] = a
        return jax.make_array_from_process_local_data(
            data_sharding(mesh), out.reshape(n_local_pad // 128, 128)
        )

    state = DPMMState(
        table=jax.device_put(
            jax.tree.map(jnp.asarray, ck["table"]), replicated(mesh)
        ),
        labels=_pad_local_i32(shard["labels"], 0),
        sublabels=_pad_local_i32(shard["sublabels"], 0),
        key=jax.device_put(jnp.asarray(ck["key"]), replicated(mesh)),
        step=ck["step"],
    )
    if k_saved != engine.cfg.k_max:
        from .sampler.driver import get_migrator

        state = get_migrator(fam, mesh)(state, engine.cfg.k_max)

    n_total = jax.device_put(
        jnp.float32(n_global),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()),
    )
    callback = _distributed_save_callback(fam, cfg, shift, n_global, n_local,
                                          scale)
    state, hist = run_loop(
        engine, state, points, valid, n_total, cfg.iters,
        first_iter=ck["step"], verbose=False, callback=callback,
        engine_fn=engine_fn, k_ceiling=k_ceiling,
    )
    table = jax.tree.map(lambda a: np.asarray(jax.device_get(a)), state.table)
    labels_local = np.concatenate(
        [np.asarray(s.data) for s in state.labels.addressable_shards]
    ).reshape(-1)[:n_local]
    sub_local = np.concatenate(
        [np.asarray(s.data) for s in state.sublabels.addressable_shards]
    ).reshape(-1)[:n_local]
    model = DPMMModel(
        family=fam, table=table, shift=shift, cfg=cfg,
        n_points=int(n_global), labels_raw=labels_local,
        sublabels=sub_local,
        key=np.asarray(jax.device_get(state.key)), step=state.step,
        scale=scale,
    )
    return FitResult(model=model, history=hist)


def run_from_checkpoint(
    path: str,
    data,
    *,
    iters: Optional[int] = None,
    gt=None,
    mesh=None,
    n_devices: Optional[int] = None,
    transposed: bool = False,
    **overrides,
) -> FitResult:
    """Resume a run from a checkpoint file (reference
    ``run_model_from_checkpoint``, src/dp-parallel-sampling.jl:428-447).
    ``data`` must be the same dataset the checkpoint was trained on."""
    ck = load_checkpoint(path)
    cfg: DPMMConfig = ck["config"]
    if iters is not None:
        overrides["iters"] = iters
    if overrides:
        cfg = cfg.replace(**overrides)
    fam = _FAMILIES[ck["family"]]

    x = _prepare_data(data, transposed)
    n, d = x.shape
    if n != ck["n_points"]:
        raise ValueError(
            f"checkpoint was trained on {ck['n_points']} points, got {n}"
        )
    shift = np.asarray(ck["shift"], np.float32)
    scale = (np.ones(d, np.float32) if ck.get("scale") is None
             else np.asarray(ck["scale"], np.float32))
    x = (x - shift) * scale

    if mesh is None:
        mesh = make_data_mesh(n_devices)
    n_dev = int(np.prod(mesh.devices.shape))
    cfg = cfg.replace(chunk_size=_effective_chunk(cfg, n, n_dev))

    # the checkpointed table may be any capacity tier; start the engine at
    # that width and let the tier loop (or a one-shot migration) adjust
    k_saved = int(np.asarray(ck["table"]["active"]).shape[0])
    cfg = _resolve_precompute(fam, cfg, n, d, n_dev)
    engine, engine_fn, k_ceiling = _tier_setup(fam, cfg, mesh, k_start=k_saved)
    points, valid, n_total = engine.shard_points(x)
    if cfg.precompute_features:
        points = engine.featurize(
            points, seed=cfg.seed if cfg.seed is not None else 0
        )
    from .sampler.assign import points_rows

    n_pad = points_rows(points)

    from .parallel.mesh import data_sharding, replicated

    def _pad_i32(a, fill):
        out = np.full((n_pad,), fill, np.int32)
        out[:n] = a
        return jax.device_put(
            out.reshape(n_pad // 128, 128), data_sharding(mesh)
        )

    table = jax.device_put(
        jax.tree.map(jnp.asarray, ck["table"]), replicated(mesh)
    )
    state = DPMMState(
        table=table,
        labels=_pad_i32(ck["labels"], 0),
        sublabels=_pad_i32(ck["sublabels"], 0),
        key=jax.device_put(jnp.asarray(ck["key"]), replicated(mesh)),
        step=ck["step"],
    )
    if k_saved != engine.cfg.k_max:
        # fixed-capacity engine with a differently-sized checkpoint table
        from .sampler.driver import get_migrator

        state = get_migrator(fam, mesh)(state, engine.cfg.k_max)

    callback = None
    if cfg.enable_saving:
        def callback(it, st, _metrics):
            if (it + 1) % cfg.model_save_interval == 0:
                _model_from_state(fam, cfg, st, shift, n, scale).save(
                    f"{cfg.save_path}{cfg.save_file_prefix}{it + 1}.npz"
                )

    state, hist = run_loop(
        engine, state, points, valid, n_total, cfg.iters,
        first_iter=ck["step"],
        gt=np.asarray(gt) if gt is not None else None,
        n_valid=n, callback=callback,
        engine_fn=engine_fn, k_ceiling=k_ceiling,
    )
    model = _model_from_state(fam, cfg, state, shift, n, scale)
    return FitResult(model=model, history=hist)
