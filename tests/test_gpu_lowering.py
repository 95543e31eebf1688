"""GPU lowering gate: every compiled program of the sampler exports for CUDA.

``jax.export`` with ``platforms=["cuda"]`` traces and lowers a program for
the GPU on any host, no card needed.  This module exports the engine's
sweep, fused-block, init-statistics and smart-init programs over the grid
of families, table widths and feature-cache layouts the sampler uses, and
checks that each module targets CUDA and calls no custom kernel outside the
CUDA libraries (every custom-call target is a ``cu*`` library entry, e.g.
``cusolver_potrf_ffi``).  What the GPU compiler itself says shows only on
the card (``chip_smoke.py``).
"""
import re

import jax
import jax.numpy as jnp
import pytest

from dpmmsubclusters_tpu.config import DPMMConfig
from dpmmsubclusters_tpu.parallel.mesh import make_data_mesh
from dpmmsubclusters_tpu.priors import GAUSSIAN, MULTINOMIAL
from dpmmsubclusters_tpu.sampler.driver import DPMMEngine

N, CHUNK, BLOCK = 1024, 512, 4
FAMILIES = {"gaussian": GAUSSIAN, "multinomial": MULTINOMIAL}


def _configs():
    """(family, d, k_slots, precompute, feature_dtype): feature_dtype only
    applies to a precomputed cache, and "hybrid" only to the Gaussian."""
    out = []
    for family, d in (("gaussian", 2), ("gaussian", 32), ("multinomial", 100)):
        dtypes = (("float32", "bfloat16", "hybrid") if family == "gaussian"
                  else ("float32", "bfloat16"))
        for k in (16, 128):
            out.append((family, d, k, False, "float32"))
            out += [(family, d, k, True, dt) for dt in dtypes]
    return out


CASES = [(prog,) + c for c in _configs()
         for prog in ("sweep", "block", "init_stats", "smart_init")
         if prog != "smart_init" or c[0] == "gaussian"]


def custom_call_targets(module_text: str) -> set:
    return set(re.findall(r"custom_call @([\w.$-]+)", module_text))


def assert_gpu_module(exported) -> None:
    """The lowered program targets CUDA and every custom call in it is a
    CUDA library entry point."""
    assert exported.platforms == ("cuda",)
    bad = {t for t in custom_call_targets(exported.mlir_module())
           if not t.startswith("cu")}
    assert not bad, bad


def _sds(tree):
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        tree)


def _abstract_state(engine, family, d):
    """Shape-only engine inputs (nothing is compiled or run)."""
    f32 = jnp.float32
    points = jax.ShapeDtypeStruct((N, d), f32)
    if engine.cfg.precompute_features:
        points = jax.eval_shape(lambda p: engine.featurize(p), points)
    streams = jax.ShapeDtypeStruct((N // 128, 128), jnp.int32)
    valid = jax.ShapeDtypeStruct((N // 128, 128), jnp.bool_)
    key = jax.eval_shape(lambda: jax.random.PRNGKey(0))
    flat3 = jax.eval_shape(engine._init_stats, points, valid, streams,
                           streams)
    prior = _sds(family.default_prior(d))
    table = jax.eval_shape(engine._build_table, key, flat3, prior, None)
    return points, valid, streams, key, flat3, table


@pytest.mark.parametrize("prog,family,d,k,precompute,dtype", CASES)
def test_program_lowers_for_cuda(prog, family, d, k, precompute, dtype):
    fam = FAMILIES[family]
    cfg = DPMMConfig(k_max=k, chunk_size=CHUNK, burnout=5,
                     precompute_features=precompute, feature_dtype=dtype)
    engine = DPMMEngine(fam, cfg, make_data_mesh(1))
    points, valid, streams, key, flat3, table = _abstract_state(
        engine, fam, d)
    scalar = jax.ShapeDtypeStruct((), jnp.float32)
    flag = jax.ShapeDtypeStruct((), jnp.bool_)
    flags = jax.ShapeDtypeStruct((BLOCK,), jnp.bool_)
    fn, args = {
        "sweep": (engine._step, (table, streams, streams, key, points,
                                 valid, scalar, flag, flag)),
        "block": (engine._step_block, (table, streams, streams, key, points,
                                       valid, scalar, flags, flags)),
        "init_stats": (engine._init_stats, (points, valid, streams,
                                            streams)),
        "smart_init": (lambda *a: engine._get_smart_init(d)(*a),
                       (points, valid, streams, streams, flat3)),
    }[prog]
    fn = fn if hasattr(fn, "lower") else jax.jit(fn)
    assert_gpu_module(jax.export.export(fn, platforms=["cuda"])(*args))


def test_gate_rejects_a_foreign_custom_call():
    """Meta-test: the checker flags a module that calls a kernel of another
    backend."""
    text = ('%0 = stablehlo.custom_call @other_backend_kernel(%arg0) '
            '{backend_config = "..."} : (tensor<8x128xf32>) -> '
            'tensor<8x128xf32>\n'
            '%1 = stablehlo.custom_call @cusolver_potrf_ffi(%0)')
    assert custom_call_targets(text) == {"other_backend_kernel",
                                         "cusolver_potrf_ffi"}

    class Fake:
        platforms = ("cuda",)

        def mlir_module(self):
            return text

    with pytest.raises(AssertionError):
        assert_gpu_module(Fake())
