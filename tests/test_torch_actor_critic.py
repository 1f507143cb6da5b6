"""ActorCritic of the port vs the JAX package, weights through utils/convert.

Tolerance 1e-5 (rtol and atol): float32 products over up to 2102 terms, summed
in another order by the two libraries.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walk_these_ways_tpu.models import actor_critic as j_ac

from walk_these_ways_tpu_torch.models import actor_critic as t_ac
from walk_these_ways_tpu_torch.utils import convert

from test_torch_util import REPO, assert_close, t

torch.set_num_threads(1)
NUM_OBS, NUM_PRIV, HIST, ACT = 70, 2, 2100, 12
TOL = 1e-5


def _flatten(p):
    out = {"std": np.asarray(p.std)}
    for name in ("adaptation", "actor", "critic"):
        mlp = getattr(p, name)
        for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
            out[f"{name}/w{i}"] = np.asarray(w)
            out[f"{name}/b{i}"] = np.asarray(b)
    return out


@pytest.fixture(scope="module")
def pair():
    pj = j_ac.init(jax.random.PRNGKey(0), NUM_OBS, NUM_PRIV, HIST, ACT)
    pj = pj._replace(std=jnp.asarray(
        np.random.RandomState(0).uniform(0.5, 1.5, ACT).astype(np.float32)))
    pt = convert.actor_critic_from_numpy(_flatten(pj), device="cpu")
    rs = np.random.RandomState(1)
    hist = rs.randn(16, HIST).astype(np.float32)
    priv = rs.randn(16, NUM_PRIV).astype(np.float32)
    return pj, pt, hist, priv


@pytest.mark.parametrize("head", ["adaptation_forward", "actor_mean",
                                  "act_teacher", "evaluate"])
def test_forward_matches_jax(pair, head):
    pj, pt, hist, priv = pair
    args = (hist, priv) if head in ("act_teacher", "evaluate") else (hist,)
    out_j = getattr(j_ac, head)(pj, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        out_t = getattr(pt, head)(*[t(a) for a in args])
    assert_close(out_t, out_j, TOL, TOL)


def test_log_prob_and_entropy_match_jax(pair):
    pj, pt, hist, priv = pair
    rs = np.random.RandomState(2)
    x = rs.randn(16, ACT).astype(np.float32)
    mean = rs.randn(16, ACT).astype(np.float32)
    std = np.broadcast_to(np.asarray(pj.std), (16, ACT)).copy()
    assert_close(t_ac.gaussian_log_prob(t(x), t(mean), t(std)),
                 j_ac.gaussian_log_prob(jnp.asarray(x), jnp.asarray(mean),
                                        jnp.asarray(std)), TOL, TOL)
    assert_close(t_ac.gaussian_entropy(t(std)),
                 j_ac.gaussian_entropy(jnp.asarray(std)), TOL, TOL)


def test_sample_actions_uses_the_generator(pair):
    pj, pt, hist, priv = pair
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    with torch.no_grad():
        a1, lp1, mean, std = pt.sample_actions(t(hist), g1)
        a2, lp2, _, _ = pt.sample_actions(t(hist), g2)
        a3, _, _, _ = pt.sample_actions(t(hist), g2)
    assert torch.equal(a1, a2) and torch.equal(lp1, lp2)
    assert not torch.equal(a2, a3)
    assert_close(mean, j_ac.actor_mean(pj, jnp.asarray(hist)), TOL, TOL)
    # the log-prob is that of the drawn action under the JAX formula
    assert_close(lp1, j_ac.gaussian_log_prob(
        jnp.asarray(a1.numpy()), jnp.asarray(mean.numpy()),
        jnp.asarray(std.detach().numpy())), 1e-4, 1e-4)


def test_seeded_init_shapes_and_bounds():
    g = torch.Generator().manual_seed(0)
    m = t_ac.ActorCritic(NUM_OBS, NUM_PRIV, HIST, ACT, generator=g,
                         device="cpu")
    shapes = [tuple(w.shape) for w in m.actor.weights]
    assert shapes == [(2102, 512), (512, 256), (256, 128), (128, 12)]
    assert [tuple(w.shape) for w in m.adaptation.weights] == \
        [(2100, 256), (256, 128), (128, 2)]
    assert tuple(m.critic.weights[-1].shape) == (128, 1)
    assert float(m.actor.weights[0].detach().abs().max()) <= 1 / np.sqrt(2102)
    assert torch.equal(m.std.data, torch.ones(ACT))
    m2 = t_ac.ActorCritic(NUM_OBS, NUM_PRIV, HIST, ACT,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert torch.equal(m.actor.weights[0], m2.actor.weights[0])


def test_committed_reference_policy_loads(pair):
    pj, pt, hist, priv = pair
    z = np.load(os.path.join(REPO, "resources", "reference_policy",
                             "pretrain_v0_policy.npz"))
    arrays = {k: z[k] for k in z.files}
    assert "actor/w0" not in arrays          # it holds no actor body
    with pytest.raises(KeyError):
        convert.actor_critic_from_numpy(arrays, device="cpu")
    m = t_ac.ActorCritic(NUM_OBS, NUM_PRIV, HIST, ACT,
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    before = m.actor.weights[0].clone()
    convert.actor_critic_from_numpy(arrays, module=m)
    assert torch.equal(m.actor.weights[0], before)
    np.testing.assert_array_equal(m.std.detach().numpy(), arrays["std"])
    ad = j_ac.MLPParams(
        weights=tuple(jnp.asarray(arrays[f"adaptation/w{i}"]) for i in range(3)),
        biases=tuple(jnp.asarray(arrays[f"adaptation/b{i}"]) for i in range(3)))
    with torch.no_grad():
        assert_close(m.adaptation_forward(t(hist)),
                     j_ac.mlp_apply(ad, jnp.asarray(hist)), 1e-4, 1e-4)
