"""The port's actor / critic / act against the JAX reference, on the CPU.

The reference's params are moved into the port by `params_from_jax`;
then both packages see the same observations and hidden states (numpy).
Tolerance rtol 1e-5 / atol 1e-6: the products are the same float32 math
with another summation order and other libm ulps for tanh / sigmoid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ddpg as jddpg
from repro.core import networks as jnets
from repro_torch.core import ddpg
from repro_torch.core.litune import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_agent():
    cfg = jnets.NetConfig(obs_dim=26, action_dim=14)   # default widths
    params = jnets.init_actor_critic(jax.random.PRNGKey(3), cfg)
    return cfg, params, jax.tree.map(np.asarray, params)


def _inputs(seed, batch=()):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=batch + (26,)).astype(np.float32)
    act = rng.uniform(-1, 1, batch + (14,)).astype(np.float32)
    h = rng.normal(size=batch + (128,)).astype(np.float32) * 0.5
    c = rng.normal(size=batch + (128,)).astype(np.float32)
    return obs, act, h, c


def test_params_from_jax_round_trip(jax_agent):
    _, _, tree = jax_agent
    state = params_from_jax(tree, device="cpu")
    sd = state["params"].state_dict()
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(sd) == len(flat)
    for path, leaf in flat:
        key = ".".join(p.key for p in path)
        np.testing.assert_array_equal(sd[key].numpy(), leaf)
    for a, b in zip(state["params"].parameters(),
                    state["targets"].parameters()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_params_from_jax_refuses_a_mismatched_tree(jax_agent):
    _, _, tree = jax_agent
    bad = jax.tree.map(lambda x: x, tree)
    bad["critic0"]["lstm"]["wi"] = bad["critic0"]["lstm"]["wi"][:-1]
    with pytest.raises(RuntimeError):
        params_from_jax(bad, device="cpu")


@pytest.mark.parametrize("batch", [(), (5,)])
def test_actor_and_critic_match_reference(jax_agent, batch):
    cfg, params, tree = jax_agent
    tparams = params_from_jax(tree, device="cpu")["params"]
    obs, act, h, c = _inputs(len(batch), batch)
    ja, (jh, jc) = jnets.actor_apply(params["actor"], jnp.asarray(obs),
                                     (jnp.asarray(h), jnp.asarray(c)), cfg)
    with torch.no_grad():
        ta, (th, tc) = tparams["actor"](torch.from_numpy(obs),
                                        (torch.from_numpy(h),
                                         torch.from_numpy(c)))
    for g, w in ((ta, ja), (th, jh), (tc, jc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    jq, (jh, jc) = jnets.critic_apply(params["critic0"], jnp.asarray(obs),
                                      jnp.asarray(act),
                                      (jnp.asarray(h), jnp.asarray(c)), cfg)
    with torch.no_grad():
        tq, (th, tc) = tparams["critic0"](
            torch.from_numpy(obs), torch.from_numpy(act),
            (torch.from_numpy(h), torch.from_numpy(c)))
    assert tq.shape == batch
    for g, w in ((tq, jq), (th, jh), (tc, jc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_act_deterministic_matches_reference(jax_agent):
    cfg, params, tree = jax_agent
    state = params_from_jax(tree, device="cpu")
    obs, _, h, c = _inputs(9)
    ja, (jh, jc) = jddpg.act(params, jnp.asarray(obs),
                             (jnp.asarray(h), jnp.asarray(c)),
                             jax.random.PRNGKey(0), cfg, deterministic=True)
    ta, (th, tc) = ddpg.act(state["params"], torch.from_numpy(obs),
                            (torch.from_numpy(h), torch.from_numpy(c)),
                            deterministic=True)
    for g, w in ((ta, ja), (th, jh), (tc, jc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # exploration noise stays inside the action box and follows the seed
    gen = torch.Generator().manual_seed(1)
    noisy = ddpg.act(state["params"], torch.from_numpy(obs),
                     (torch.from_numpy(h), torch.from_numpy(c)), gen,
                     noise_scale=2.0)[0]
    assert noisy.abs().max() <= 1.0 and not torch.equal(noisy, ta)
