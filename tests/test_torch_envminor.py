"""`build_cache_envminor` of the port vs the JAX package, leaf by leaf.

Tolerance: rtol 1e-5 with an absolute floor of 1e-5 on the M^-1 leaf (entries
reach 1e2 and come out of a chain of closed-form inverses) and 1e-6 on the
others.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walk_these_ways_tpu.models.robot import go1 as j_go1
from walk_these_ways_tpu.physics import engine as j_engine
from walk_these_ways_tpu.physics import envminor as j_em

from walk_these_ways_tpu_torch.models.robot import go1 as t_go1
from walk_these_ways_tpu_torch.physics import engine as t_engine
from walk_these_ways_tpu_torch.physics import envminor as t_em
from walk_these_ways_tpu_torch.utils import convert

from test_torch_util import assert_close, random_dyn_np, random_phys_np, t

torch.set_num_threads(1)
N, BLOCK = 8, 16


@pytest.fixture(scope="module")
def caches():
    ph, dy = random_phys_np(N, 3), random_dyn_np(N, 3)
    sj = j_engine.PhysicsState(**{k: jnp.asarray(v) for k, v in ph.items()})
    dj = j_engine.DynamicsParams(**{k: jnp.asarray(v) for k, v in dy.items()})
    st = convert.physics_state_from_numpy(ph, device="cpu")
    dt_ = t_engine.DynamicsParams(**{k: t(v) for k, v in dy.items()})
    return (j_em.build_cache_envminor(j_go1(), sj, dj, BLOCK),
            t_em.build_cache_envminor(t_go1(), st, dt_, BLOCK),
            (sj, dj, st, dt_))


@pytest.mark.parametrize("leaf", t_em.EnvMinorCache._fields)
def test_cache_leaf_matches_jax(caches, leaf):
    cj, ct, _ = caches
    a, b = getattr(ct, leaf), getattr(cj, leaf)
    assert tuple(a.shape) == b.shape and a.shape[-1] == BLOCK
    assert a.dtype == torch.float32
    assert_close(a, b, 1e-5, 1e-5 if leaf == "Minv_t" else 1e-6, err_msg=leaf)
    assert float(a[..., N:].abs().max()) == 0.0          # the padding


def test_kernel_inputs_match_jax(caches):
    _, _, (sj, dj, st, dt_) = caches
    outs_j = j_engine.build_pallas_env_inputs(j_go1(), sj, dj, None, BLOCK)
    outs_t = t_engine.build_pallas_env_inputs(
        t_go1(), st, dt_, t_engine.flat_terrain("cpu"), BLOCK)
    assert outs_j[5] is None and outs_t[5] is None
    for name, a, b in zip(("rh", "mu", "e", "g"), outs_t[1:5], outs_j[1:5]):
        assert a.is_contiguous(), name
        assert_close(a, b, 1e-6, 1e-7, err_msg=name)
    # mu = 0.5 * (friction + 1): ground friction 1 averaged in
    assert_close(outs_t[2][0, :N], 0.5 * (np.asarray(dj.friction) + 1.0),
                 1e-6, 1e-7)
