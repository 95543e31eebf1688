"""Normal-Inverse-Wishart conjugate prior for multivariate-Gaussian clusters.

Re-design of ``src/priors/niw.jl`` + ``src/distributions/mv_gaussian.jl``.

Parameterization matches the reference exactly (``src/priors/niw.jl:20-31``):
``psi`` is the "divided-by-nu" scale, i.e. the inverse-Wishart scale matrix is
``nu * psi``, and the posterior is

    kappa' = kappa + N;  nu' = nu + N
    m'     = (kappa*m + sum_x) / kappa'
    psi'   = (nu*psi + kappa*m m^T - kappa'*m' m'^T + sum_xx) / nu'   (symmetrized)

Log marginal likelihood follows ``src/priors/niw.jl:53-62``.  Unlike the
reference's ``mv_gaussian`` log-pdf -- which uses ``length(Sigma)`` (= D^2) in
the normalizing constant instead of D (``src/distributions/mv_gaussian.jl:24``,
a bug that cancels in the label softmax) -- we use the correct constant.

Parameter sampling replaces Julia's ``rand(InverseWishart)`` + dense inverse +
Cholesky (``src/priors/niw.jl:34-40``) with a direct Bartlett draw of the
*precision* matrix (see :func:`..ops.linalg.sample_wishart_precision`).

All arrays are float32: the reference promotes sufficient statistics to
Float64 (``src/priors/niw.jl:46``); here we instead keep data centered
(handled at the API layer) and accumulate the `sum_xx` GEMMs in float32 at
``Precision.HIGHEST``, which the statistical tests validate.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from ..ops import linalg
from ..ops.linalg import LOG_PI, LOG_2PI


class GaussianFamily:
    name = "gaussian"

    # ---- shapes -----------------------------------------------------------
    def feature_dim(self, d: int) -> int:
        return 1 + d + (d * (d + 1)) // 2

    def stat_dim(self, d: int) -> int:
        return self.feature_dim(d)

    @staticmethod
    def _triu(d: int):
        import numpy as _np

        return _np.triu_indices(d)

    # ---- per-point linear maps -------------------------------------------
    def features(self, x: jax.Array) -> jax.Array:
        """[N, D] -> [N, 1 + D + D(D+1)/2]: rows [1, x, packed(x x^T)].

        ``x x^T`` is symmetric, so only the upper triangle is materialized
        (row-major triu order) -- half the FLOPs/bytes of the naive D^2
        layout.  ONE feature map serves both hot uses:
          * ``ll = feat @ phi`` with phi = [c, P mu, packed(-0.5 P) with
            doubled off-diagonals] is the Gaussian log-density;
          * ``onehot(label, sub)^T @ feat`` is the per-(slot, side)
            sufficient-statistics reduction (suff stats store the packed
            upper triangle of sum_xx).
        """
        n, d = x.shape
        ones = jnp.ones((n, 1), dtype=x.dtype)
        # upper triangle by rows: j-th segment is x_j * x_{j:} (width d - j)
        segs = [x[:, j : j + 1] * x[:, j:] for j in range(d)]
        return jnp.concatenate([ones, x] + segs, axis=1)

    def stat_features(self, x: jax.Array) -> jax.Array:
        """Alias: statistics rows ARE the feature rows (shared layout)."""
        return self.features(x)

    def pack_sym(self, mat: jax.Array, double_offdiag: bool) -> jax.Array:
        """[..., D, D] symmetric -> packed [..., D(D+1)/2] (triu row-major).

        ``double_offdiag=True`` packs a *coefficient* vector: off-diagonal
        entries doubled so that ``packed(coeff) . packed(xx)`` equals the
        full bilinear form ``sum_ij coeff_ij x_i x_j``.
        """
        d = mat.shape[-1]
        iu, ju = self._triu(d)
        out = mat[..., iu, ju]
        if double_offdiag:
            scale = jnp.where(jnp.asarray(iu == ju), 1.0, 2.0).astype(mat.dtype)
            out = out * scale
        return out

    def unpack_sym(self, packed: jax.Array, d: int) -> jax.Array:
        """packed [..., D(D+1)/2] -> full symmetric [..., D, D]."""
        iu, ju = self._triu(d)
        full = jnp.zeros(packed.shape[:-1] + (d, d), packed.dtype)
        full = full.at[..., iu, ju].set(packed)
        diag = jnp.zeros(packed.shape[:-1] + (d, d), packed.dtype).at[
            ..., jnp.arange(d), jnp.arange(d)
        ].set(full[..., jnp.arange(d), jnp.arange(d)])
        return full + jnp.swapaxes(full, -1, -2) - diag

    # ---- sufficient statistics -------------------------------------------
    def empty_stats(self, batch_shape: tuple, d: int):
        return {
            "n": jnp.zeros(batch_shape, jnp.float32),
            "sum_x": jnp.zeros(batch_shape + (d,), jnp.float32),
            "sum_xx": jnp.zeros(batch_shape + (d, d), jnp.float32),
        }

    def stats_from_flat(self, flat: jax.Array, d: int):
        # flat may carry zero padding columns beyond stat_dim(d): the
        # feature cache is padded to a multiple of 128 columns (see
        # assign.pad_features)
        s = self.stat_dim(d)
        return {
            "n": flat[..., 0],
            "sum_x": flat[..., 1 : 1 + d],
            "sum_xx": self.unpack_sym(flat[..., 1 + d : s], d),
        }

    def stats_to_flat(self, stats) -> jax.Array:
        return jnp.concatenate(
            [
                stats["n"][..., None],
                stats["sum_x"],
                self.pack_sym(stats["sum_xx"], double_offdiag=False),
            ],
            axis=-1,
        )

    def aggregate_stats(self, a, b):
        # reference: src/priors/niw.jl:64-66 (elementwise add)
        return jax.tree.map(jnp.add, a, b)

    # ---- conjugate updates ------------------------------------------------
    def calc_posterior(self, prior, stats):
        """Batched NIW posterior update (reference src/priors/niw.jl:20-31).

        Slots with N == 0 return the prior unchanged.
        """
        n = stats["n"]
        has = n > 0
        nsafe = jnp.where(has, n, 1.0)
        kappa = prior["kappa"] + n
        nu = prior["nu"] + n
        m = (prior["kappa"][..., None] * prior["m"] + stats["sum_x"]) / kappa[
            ..., None
        ]
        mm0 = prior["m"][..., :, None] * prior["m"][..., None, :]
        mm1 = m[..., :, None] * m[..., None, :]
        psi = (
            prior["nu"][..., None, None] * prior["psi"]
            + prior["kappa"][..., None, None] * mm0
            - kappa[..., None, None] * mm1
            + stats["sum_xx"]
        ) / nu[..., None, None]
        psi = 0.5 * (psi + jnp.swapaxes(psi, -1, -2))
        del nsafe
        h = has[..., None]
        hh = has[..., None, None]
        return {
            "kappa": jnp.where(has, kappa, prior["kappa"]),
            "m": jnp.where(h, m, prior["m"]),
            "nu": jnp.where(has, nu, prior["nu"]),
            "psi": jnp.where(hh, psi, prior["psi"]),
        }

    def augment_prior(self, prior_k):
        """Attach per-slot caches of the prior-only log-marginal terms --
        ``ld0`` = log|psi0| and ``lgmv0`` = log Gamma_D(nu0/2).  Prior rows
        only ever move wholesale (split scatter, tier remap), so the caches
        ride along as extra pytree leaves and kill one batched Cholesky +
        one lgamma sum from EVERY log-marginal evaluation (several per
        sweep)."""
        d = prior_k["m"].shape[-1]
        psi = prior_k["psi"]
        ld0 = linalg.chol_logdet(
            linalg.masked_cholesky(psi, jnp.ones(psi.shape[:-2], bool))
        )
        lgmv0 = linalg.log_multivariate_gamma(prior_k["nu"] / 2.0, d)
        return {**prior_k, "ld0": ld0, "lgmv0": lgmv0}

    def posterior_cache(self, posterior, mask):
        """Factor the posterior psi ONCE per (post, mask): the factor serves
        both :meth:`log_marginal` (log-determinant) and
        :meth:`sample_params` (Bartlett scale -- chol(nu*psi) =
        sqrt(nu)*chol(psi))."""
        chol = linalg.masked_cholesky(posterior["psi"], mask)
        return {"chol": chol, "ld": linalg.chol_logdet(chol)}

    def log_marginal(self, prior, posterior, stats, mask,
                     cache=None) -> jax.Array:
        """Batched log marginal likelihood (reference src/priors/niw.jl:53-62).

        Returns 0 where ``mask`` is False or N == 0 (the reference formula
        also evaluates to 0 when posterior == prior).  ``cache``: the
        posterior factorization from :meth:`posterior_cache`; prior-side
        terms come cached from :meth:`augment_prior` when present.
        """
        d = prior["m"].shape[-1]
        valid = mask & (stats["n"] > 0)
        if "ld0" in prior:
            ld0 = prior["ld0"]
            lgmv0 = prior["lgmv0"]
        else:
            ld0 = linalg.chol_logdet(
                linalg.masked_cholesky(prior["psi"], valid)
            )
            lgmv0 = linalg.log_multivariate_gamma(prior["nu"] / 2.0, d)
        if cache is not None:
            ld1 = cache["ld"]
        else:
            ld1 = linalg.chol_logdet(
                linalg.masked_cholesky(posterior["psi"], valid)
            )
        nu0, nu1 = prior["nu"], posterior["nu"]
        out = (
            -stats["n"] * d * 0.5 * LOG_PI
            + linalg.log_multivariate_gamma(nu1 / 2.0, d)
            - lgmv0
            + (nu0 / 2.0) * (d * jnp.log(nu0) + ld0)
            - (nu1 / 2.0) * (d * jnp.log(nu1) + ld1)
            + (d / 2.0) * jnp.log(prior["kappa"] / posterior["kappa"])
        )
        return jnp.where(valid, out, 0.0)

    def log_marginal_pairwise(self, prior, stats, mask) -> jax.Array:
        """[K, K] log marginal likelihood of every merged pair (i, j).

        Equivalent to calling :meth:`calc_posterior` + :meth:`log_marginal`
        per pair (the reference's should_merge!, src/shared_actions.jl:21-38,
        with prior_i), but prior-only terms (prior Cholesky, prior
        multivariate gamma) are computed per-slot instead of per-pair --
        only the merged-posterior Cholesky is O(K^2).
        """
        d = prior["m"].shape[-1]
        n_m = stats["n"][:, None] + stats["n"][None, :]          # [K, K]
        sx = stats["sum_x"][:, None, :] + stats["sum_x"][None, :, :]
        sxx = stats["sum_xx"][:, None] + stats["sum_xx"][None, :]

        k0 = prior["kappa"][:, None]                              # [K, 1]
        nu0 = prior["nu"][:, None]
        m0 = prior["m"][:, None, :]                               # [K, 1, D]
        kappa1 = k0 + n_m
        nu1 = nu0 + n_m
        m1 = (k0[..., None] * m0 + sx) / kappa1[..., None]        # [K, K, D]
        mm0 = m0[..., :, None] * m0[..., None, :]                 # [K, 1, D, D]
        mm1 = m1[..., :, None] * m1[..., None, :]
        psi1 = (
            nu0[..., None, None] * prior["psi"][:, None]
            + k0[..., None, None] * mm0
            - kappa1[..., None, None] * mm1
            + sxx
        ) / nu1[..., None, None]
        psi1 = 0.5 * (psi1 + jnp.swapaxes(psi1, -1, -2))

        pair_mask = mask[:, None] & mask[None, :] & (n_m > 0)
        ld1 = linalg.chol_logdet(linalg.masked_cholesky(psi1, pair_mask))
        # per-slot prior terms (cached by augment_prior when present)
        if "ld0" in prior:
            ld0 = prior["ld0"][:, None]
            lgmv0 = prior["lgmv0"][:, None]
        else:
            ld0 = linalg.chol_logdet(
                linalg.masked_cholesky(prior["psi"], mask)
            )[:, None]
            lgmv0 = linalg.log_multivariate_gamma(
                prior["nu"] / 2.0, d
            )[:, None]

        out = (
            -n_m * d * 0.5 * LOG_PI
            + linalg.log_multivariate_gamma(nu1 / 2.0, d)
            - lgmv0
            + (nu0 / 2.0) * (d * jnp.log(nu0) + ld0)
            - (nu1 / 2.0) * (d * jnp.log(nu1) + ld1)
            + (d / 2.0) * jnp.log(k0 / kappa1)
        )
        return jnp.where(pair_mask, out, 0.0)

    def merge_screen_score(self, post_w, params_w) -> jax.Array:
        """Cheap [K, K] mergeability score (lower = closer): symmetric
        Mahalanobis distance between posterior means under the sampled
        precisions.  Used to pick top-M candidate pairs for the exact MH
        merge evaluation (``merge_candidates`` config)."""
        mu = post_w["m"]                      # [K, D]
        prec = params_w["prec"]               # [K, D, D]
        k, d = mu.shape
        pm = jnp.einsum("ide,ie->id", prec, mu)            # P_i mu_i
        s = jnp.einsum("id,id->i", pm, mu)                 # mu_i P_i mu_i
        c = mu @ pm.T                                      # [k(k), i]: mu_k P_i mu_i
        m2 = (mu[:, :, None] * mu[:, None, :]).reshape(k, d * d)
        q = prec.reshape(k, d * d) @ m2.T                  # [i, k]: mu_k P_i mu_k
        dist = q - 2.0 * c.T + s[:, None]                  # [i, k]
        return dist + dist.T

    # ---- sampling ---------------------------------------------------------
    def sample_params(self, key, hyper, mask, cache=None):
        """Draw (mu, Sigma) from the NIW and pack natural parameters.

        Reference src/priors/niw.jl:34-40, re-done via Bartlett on the
        precision.  ``cache`` (from :meth:`posterior_cache`) supplies the
        psi Cholesky factor so it isn't re-computed here.  Returns a pytree:
          phi          [..., D^2+D+1]  natural params for the ll matmul
          mu           [..., D]
          prec         [..., D, D]     P = Sigma^-1
          logdet_sigma [...]
        """
        d = hyper["m"].shape[-1]
        kp, km = jax.random.split(key)
        prec, factors, logdet_sigma = linalg.sample_wishart_precision(
            kp, hyper["nu"], hyper["psi"], mask,
            chol_psi=None if cache is None else cache["chol"],
        )
        mu = linalg.sample_mvn_from_precision_factors(
            km, hyper["m"], factors, hyper["kappa"]
        )
        h = jnp.einsum("...ij,...j->...i", prec, mu,
                       precision=jax.lax.Precision.HIGHEST)
        quad = jnp.einsum("...i,...i->...", mu, h)
        c = -0.5 * (d * LOG_2PI + logdet_sigma + quad)
        phi = jnp.concatenate(
            [
                c[..., None],
                h,
                self.pack_sym(-0.5 * prec, double_offdiag=True),
            ],
            axis=-1,
        )
        return {
            "phi": phi,
            "mu": mu,
            "prec": prec,
            "logdet_sigma": logdet_sigma,
        }

    # ---- prediction -------------------------------------------------------
    def posterior_predictive(self, x: jax.Array, hyper) -> jax.Array:
        """Multivariate Student-t posterior predictive log-density.

        Reference src/priors/niw.jl:68-76:
        ``MvTDist(nu-D+1, m, ((kappa+1)/(kappa*(nu-D+1))) * nu * psi)``.

        x: [N, D]; hyper batched [...]; returns [N, ...].
        """
        d = x.shape[-1]
        nu_t = hyper["nu"] - d + 1.0  # [...]
        scale = (
            ((hyper["kappa"] + 1.0) / (hyper["kappa"] * nu_t))[..., None, None]
            * hyper["nu"][..., None, None]
            * hyper["psi"]
        )
        chol = linalg.masked_cholesky(scale, jnp.ones(nu_t.shape, bool))
        logdet = linalg.chol_logdet(chol)
        # Mahalanobis distances, batched over hyper: diffs[..., d, n] = x[n,d] - m[..., d]
        diffs = jnp.swapaxes(x, 0, 1) - hyper["m"][..., None]  # [..., D, N]
        y = jax.lax.linalg.triangular_solve(
            chol, diffs, left_side=True, lower=True
        )
        m2 = jnp.sum(y * y, axis=-2)  # [..., N]
        ll = (
            gammaln((nu_t + d) / 2.0)
            - gammaln(nu_t / 2.0)
            - 0.5 * d * (jnp.log(nu_t) + LOG_PI)
            - 0.5 * logdet
        )[..., None] - 0.5 * (nu_t[..., None] + d) * jnp.log1p(
            m2 / nu_t[..., None]
        )
        return jnp.moveaxis(ll, -1, 0)  # [N, ...]

    # ---- convenience ------------------------------------------------------
    def default_prior(self, d: int):
        """Weak default prior: NIW(1, 0, D+3, I) (reference
        src/dp-parallel-sampling.jl:270-277)."""
        return {
            "kappa": jnp.asarray(1.0, jnp.float32),
            "m": jnp.zeros((d,), jnp.float32),
            "nu": jnp.asarray(d + 3.0, jnp.float32),
            "psi": jnp.eye(d, dtype=jnp.float32),
        }

    def make_prior(self, kappa, m, nu, psi):
        m = jnp.asarray(m, jnp.float32)
        return {
            "kappa": jnp.asarray(kappa, jnp.float32),
            "m": m,
            "nu": jnp.asarray(nu, jnp.float32),
            "psi": jnp.asarray(psi, jnp.float32),
        }

    def tile_prior(self, prior, batch_shape: tuple):
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, batch_shape + a.shape), prior
        )

    def shift_prior(self, prior, shift):
        """Translate the prior mean (used by data auto-centering)."""
        out = dict(prior)
        out["m"] = prior["m"] + shift
        return out

    def scale_prior(self, prior, scale):
        """Rescale the prior for per-dimension standardized data x' = s*x
        (config ``standardize_data``): NIW is closed under diagonal scaling
        -- m' = s*m, psi' = diag(s) psi diag(s); kappa/nu are unchanged and
        every Hastings ratio / assignment probability is invariant."""
        s = jnp.asarray(scale, jnp.float32)
        out = dict(prior)
        out["m"] = prior["m"] * s
        out["psi"] = prior["psi"] * (s[:, None] * s[None, :])
        return out


GAUSSIAN = GaussianFamily()
