"""The pure-JAX networks against the flax.linen modules they replace.

For each network config the in-repo module must build the same parameter tree
(names, shapes AND initial values, since init keys are derived the way flax
derives them) and, given the same params, produce the same outputs. The flax
definitions below are the previous implementation, kept here as the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mava_jax.distributions import MaskedCategorical, TanhNormal
from mava_jax.networks import actor_critic as ours
from mava_jax.networks.factory import make_action_head, make_torso
from mava_jax.types import Observation, ObservationGlobalState


@pytest.fixture(scope="module")
def flax_nets():
    nn = pytest.importorskip("flax.linen")
    orthogonal = nn.initializers.orthogonal

    class MLPTorso(nn.Module):
        layer_sizes: tuple
        activation: str = "relu"
        use_layer_norm: bool = False

        @nn.compact
        def __call__(self, x):
            act = {"relu": nn.relu, "tanh": nn.tanh}[self.activation]
            for size in self.layer_sizes:
                x = nn.Dense(size, kernel_init=orthogonal(np.sqrt(2)))(x)
                if self.use_layer_norm:
                    x = nn.LayerNorm(use_scale=False)(x)
                x = act(x)
            return x

    class CNNTorso(nn.Module):
        channel_sizes: tuple
        kernel_sizes: tuple
        strides: tuple
        activation: str = "relu"
        use_layer_norm: bool = False
        compute_dtype: str = "float32"

        @nn.compact
        def __call__(self, x):
            act = {"relu": nn.relu, "tanh": nn.tanh}[self.activation]
            dtype = jnp.dtype(self.compute_dtype)
            x = x.astype(dtype)
            for c, k, s in zip(self.channel_sizes, self.kernel_sizes, self.strides):
                x = nn.Conv(c, (k, k), (s, s), dtype=dtype)(x)
                if self.use_layer_norm:
                    x = nn.LayerNorm(use_scale=False, dtype=dtype)(x)
                x = act(x)
            return jax.lax.collapse(x.astype(jnp.float32), x.ndim - 3)

    class DiscreteActionHead(nn.Module):
        action_dim: int

        @nn.compact
        def __call__(self, emb, observation):
            logits = nn.Dense(self.action_dim, kernel_init=orthogonal(0.01))(emb)
            return MaskedCategorical(logits, observation.action_mask)

    class ContinuousActionHead(nn.Module):
        action_dim: int
        min_scale: float = 1e-3
        independent_std: bool = True

        @nn.compact
        def __call__(self, emb, observation):
            loc = nn.Dense(self.action_dim, kernel_init=orthogonal(0.01))(emb)
            if self.independent_std:
                log_std = self.param("log_std", nn.initializers.zeros, (self.action_dim,))
            else:
                log_std = nn.Dense(self.action_dim, kernel_init=orthogonal(0.01))(emb)
            scale = jax.nn.softplus(log_std) + self.min_scale
            return TanhNormal(loc, jnp.broadcast_to(scale, loc.shape))

    def critic_input(observation, centralised):
        return observation.global_state if centralised else observation.agents_view

    class FeedForwardActor(nn.Module):
        torso: nn.Module
        action_head: nn.Module

        @nn.compact
        def __call__(self, observation):
            return self.action_head(self.torso(observation.agents_view), observation)

    class FeedForwardValueNet(nn.Module):
        torso: nn.Module
        centralised_critic: bool = False

        @nn.compact
        def __call__(self, observation):
            x = self.torso(critic_input(observation, self.centralised_critic))
            return jnp.squeeze(nn.Dense(1, kernel_init=orthogonal(1.0))(x), -1)

    class FeedForwardQNet(nn.Module):
        torso: nn.Module
        centralised_critic: bool = False

        @nn.compact
        def __call__(self, observation, action):
            x = critic_input(observation, self.centralised_critic)
            x = self.torso(jnp.concatenate([x, action], axis=-1))
            return jnp.squeeze(nn.Dense(1, kernel_init=orthogonal(1.0))(x), -1)

    class ScannedRNN(nn.Module):
        hidden_state_dim: int = 128
        collect_carries: bool = False

        @nn.compact
        def __call__(self, carry, x):
            ins, resets = x
            hidden = self.hidden_state_dim
            w_i = self.param(
                "wi", nn.initializers.lecun_normal(), (ins.shape[-1], 3 * hidden)
            )
            b_i = self.param("bi", nn.initializers.zeros_init(), (3 * hidden,))
            w_h = self.param("wh", ours._blockwise_orthogonal, (hidden, 3 * hidden))
            b_hn = self.param("bhn", nn.initializers.zeros_init(), (hidden,))
            collect = self.collect_carries

            def step(h_prev, inp):
                g_t, reset_t = inp
                h = jnp.where(reset_t[..., jnp.newaxis], 0.0, h_prev)
                xr, xz, xn = jnp.split(g_t, 3, axis=-1)
                hr, hz, hn = jnp.split(h @ w_h, 3, axis=-1)
                r = jax.nn.sigmoid(xr + hr)
                z = jax.nn.sigmoid(xz + hz)
                n = jnp.tanh(xn + r * (hn + b_hn))
                new_h = (1.0 - z) * n + z * h
                return new_h, ((h_prev, new_h) if collect else new_h)

            return jax.lax.scan(step, carry, (ins @ w_i + b_i, resets))

    class RecurrentActor(nn.Module):
        pre_torso: nn.Module
        post_torso: nn.Module
        action_head: nn.Module
        hidden_state_dim: int = 128

        @nn.compact
        def __call__(self, h, observation_done):
            observation, done = observation_done
            emb = self.pre_torso(observation.agents_view)
            h, emb = ScannedRNN(self.hidden_state_dim)(h, (emb, done))
            return h, self.action_head(self.post_torso(emb), observation)

    class RecurrentValueNet(nn.Module):
        pre_torso: nn.Module
        post_torso: nn.Module
        centralised_critic: bool = False
        hidden_state_dim: int = 128
        collect_carries: bool = False

        @nn.compact
        def __call__(self, h, observation_done):
            observation, done = observation_done
            emb = self.pre_torso(critic_input(observation, self.centralised_critic))
            h, out = ScannedRNN(self.hidden_state_dim, self.collect_carries)(
                h, (emb, done)
            )
            carries, emb = out if self.collect_carries else (None, out)
            value = nn.Dense(1, kernel_init=orthogonal(1.0))(self.post_torso(emb))
            value = jnp.squeeze(value, axis=-1)
            return h, ((carries, value) if self.collect_carries else value)

    class RecQNetwork(nn.Module):
        pre_torso: nn.Module
        post_torso: nn.Module
        num_actions: int
        hidden_state_dim: int = 128

        @nn.compact
        def get_q_values(self, h, observations_resets):
            obs, resets = observations_resets
            emb = self.pre_torso(obs.agents_view)
            h, emb = ScannedRNN(self.hidden_state_dim)(h, (emb, resets))
            emb = self.post_torso(emb)
            return h, nn.Dense(self.num_actions, kernel_init=orthogonal(0.01))(emb)

    return {
        "MLPTorso": MLPTorso,
        "CNNTorso": CNNTorso,
        "DiscreteActionHead": DiscreteActionHead,
        "ContinuousActionHead": ContinuousActionHead,
        "FeedForwardActor": FeedForwardActor,
        "FeedForwardValueNet": FeedForwardValueNet,
        "FeedForwardQNet": FeedForwardQNet,
        "ScannedRNN": ScannedRNN,
        "RecurrentActor": RecurrentActor,
        "RecurrentValueNet": RecurrentValueNet,
        "RecQNetwork": RecQNetwork,
    }


def _torso(flax_nets, cfg):
    cfg = dict(cfg)
    kind = cfg.pop("type")
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    return flax_nets[kind](**cfg), make_torso(dict(cfg, type=kind))


def _head(flax_nets, cfg, action_dim):
    cfg = dict(cfg)
    kind = cfg.pop("type")
    return flax_nets[kind](action_dim=action_dim, **cfg), make_action_head(
        dict(cfg, type=kind), action_dim
    )


def _dist_arrays(out):
    """Reduce a network output to its arrays (a distribution to its parameters)."""
    if hasattr(out, "logits"):
        return [out.logits]
    if hasattr(out, "loc") and hasattr(out, "scale"):
        return [out.loc, out.scale]
    if isinstance(out, tuple):
        return [a for o in out for a in _dist_arrays(o)]
    return [out]


MLP = {"type": "MLPTorso", "layer_sizes": [16, 8], "activation": "relu"}
MLP_LN = {"type": "MLPTorso", "layer_sizes": [16], "use_layer_norm": True,
          "activation": "tanh"}
CNN = {"type": "CNNTorso", "channel_sizes": [4, 6], "kernel_sizes": [3, 2],
       "strides": [1, 2], "activation": "relu"}
CNN_LN_BF16 = dict(CNN, use_layer_norm=True, compute_dtype="bfloat16")
DISCRETE = {"type": "DiscreteActionHead"}
CONT_INDEP = {"type": "ContinuousActionHead"}
CONT_DEP = {"type": "ContinuousActionHead", "independent_std": False}

T, E, A, F, ACT = 3, 4, 2, 7, 5


def _obs(key, lead, grid=False, global_state=False):
    k1, k2 = jax.random.split(key)
    view_shape = lead + ((5, 5, 3) if grid else (F,))
    kw = dict(
        agents_view=jax.random.normal(k1, view_shape),
        action_mask=jax.random.bernoulli(k2, 0.7, lead + (ACT,)).at[..., 0].set(True),
        step_count=jnp.zeros(lead, jnp.int32),
    )
    if global_state:
        return ObservationGlobalState(
            global_state=jax.random.normal(k2, lead + (2 * F,)), **kw
        )
    return Observation(**kw)


def _build(name, flax_nets):
    """-> (flax module, our module, inputs, method) for one network config."""
    key = jax.random.PRNGKey(1)
    if name.startswith("ff_actor"):
        torso, head = {
            "ff_actor_mlp": (MLP, DISCRETE),
            "ff_actor_mlp_layernorm": (MLP_LN, DISCRETE),
            "ff_actor_continuous": (MLP, CONT_INDEP),
            "ff_actor_continuous_state_std": (MLP, CONT_DEP),
            "ff_actor_cnn": (CNN, DISCRETE),
            "ff_actor_cnn_layernorm_bf16": (CNN_LN_BF16, DISCRETE),
        }[name]
        ft, ot = _torso(flax_nets, torso)
        fh, oh = _head(flax_nets, head, ACT)
        grid = torso["type"] == "CNNTorso"
        return (
            flax_nets["FeedForwardActor"](ft, fh),
            ours.FeedForwardActor(ot, oh),
            (_obs(key, (E, A), grid=grid),),
            "__call__",
        )
    if name in ("ff_value", "ff_value_centralised"):
        central = name.endswith("centralised")
        ft, ot = _torso(flax_nets, MLP)
        return (
            flax_nets["FeedForwardValueNet"](ft, central),
            ours.FeedForwardValueNet(ot, central),
            (_obs(key, (E, A), global_state=central),),
            "__call__",
        )
    if name == "ff_q":
        ft, ot = _torso(flax_nets, MLP)
        action = jax.random.uniform(key, (E, A, 3), minval=-1, maxval=1)
        return (
            flax_nets["FeedForwardQNet"](ft),
            ours.FeedForwardQNet(ot),
            (_obs(key, (E, A)), action),
            "__call__",
        )
    h0 = 0.1 * jax.random.normal(key, (E, A, 8))
    dones = jax.random.bernoulli(jax.random.PRNGKey(2), 0.3, (T, E, A))
    (fpre, opre), (fpost, opost) = _torso(flax_nets, MLP), _torso(flax_nets, MLP)
    if name == "rec_actor":
        fh, oh = _head(flax_nets, DISCRETE, ACT)
        return (
            flax_nets["RecurrentActor"](fpre, fpost, fh, hidden_state_dim=8),
            ours.RecurrentActor(opre, opost, oh, hidden_state_dim=8),
            (h0, (_obs(key, (T, E, A)), dones)),
            "__call__",
        )
    if name in ("rec_value", "rec_value_collect_carries"):
        collect = name.endswith("carries")
        return (
            flax_nets["RecurrentValueNet"](
                fpre, fpost, hidden_state_dim=8, collect_carries=collect
            ),
            ours.RecurrentValueNet(
                opre, opost, hidden_state_dim=8, collect_carries=collect
            ),
            (h0, (_obs(key, (T, E, A)), dones)),
            "__call__",
        )
    assert name == "rec_q"
    return (
        flax_nets["RecQNetwork"](fpre, fpost, ACT, hidden_state_dim=8),
        ours.RecQNetwork(opre, opost, ACT, hidden_state_dim=8),
        (h0, (_obs(key, (T, E, A)), dones)),
        "get_q_values",
    )


NETWORKS = [
    "ff_actor_mlp",
    "ff_actor_mlp_layernorm",
    "ff_actor_continuous",
    "ff_actor_continuous_state_std",
    "ff_actor_cnn",
    "ff_actor_cnn_layernorm_bf16",
    "ff_value",
    "ff_value_centralised",
    "ff_q",
    "rec_actor",
    "rec_value",
    "rec_value_collect_carries",
    "rec_q",
]


@pytest.mark.parametrize("name", NETWORKS)
def test_network_matches_flax(name, flax_nets):
    flax_net, our_net, inputs, method = _build(name, flax_nets)
    key = jax.random.PRNGKey(7)
    flax_method = method if method != "__call__" else None
    flax_params = flax_net.init(key, *inputs, method=flax_method)
    our_params = our_net.init(key, *inputs, method=method)

    # Same tree (names, nesting, shapes) and the same initial values.
    assert jax.tree.structure(our_params) == jax.tree.structure(
        jax.tree.map(lambda x: x, flax_params)
    )
    for got, want in zip(jax.tree.leaves(our_params), jax.tree.leaves(flax_params)):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    # Same outputs from the same (perturbed, so biases are non-zero) params.
    params = jax.tree.map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(3), x.shape),
        flax_params,
    )
    want = flax_net.apply(params, *inputs, method=flax_method)
    got = our_net.apply(params, *inputs, method=method)
    tol = 2e-2 if "bf16" in name else 1e-6
    for g, w in zip(_dist_arrays(got), _dist_arrays(want)):
        for gl, wl in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            assert gl.shape == wl.shape
            np.testing.assert_allclose(
                np.asarray(gl, np.float32), np.asarray(wl, np.float32),
                rtol=tol, atol=tol,
            )


def test_apply_under_jit_vmap_and_grad():
    """The module system composes with jit, vmap over a params axis, and grad."""
    net = ours.FeedForwardValueNet(make_torso(MLP))
    obs = _obs(jax.random.PRNGKey(0), (E, A))
    params = jax.vmap(net.init, in_axes=(0, None))(
        jax.random.split(jax.random.PRNGKey(1), 3), obs
    )
    values = jax.jit(jax.vmap(net.apply, in_axes=(0, None)))(params, obs)
    assert values.shape == (3, E, A)
    grads = jax.grad(lambda p: net.apply(p, obs).sum())(
        jax.tree.map(lambda x: x[0], params)
    )
    assert jax.tree.structure(grads) == jax.tree.structure(
        jax.tree.map(lambda x: x[0], params)
    )


def test_apply_missing_param_names_its_path():
    net = ours.FeedForwardValueNet(make_torso(MLP))
    obs = _obs(jax.random.PRNGKey(0), (E, A))
    params = net.init(jax.random.PRNGKey(1), obs)
    del params["params"]["torso"]["Dense_1"]["bias"]
    with pytest.raises(KeyError, match="torso/Dense_1/bias"):
        net.apply(params, obs)
