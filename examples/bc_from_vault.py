"""Offline MARL from a Vault: behaviour-clone a policy from stored experience.

The experience-recording system (`mava_jax/advanced_usage/
ff_ippo_store_experience.py`, reference parity) writes PPO rollouts to a
`Vault`; this example closes the loop the reference leaves open — it CONSUMES
a vault: loads the named trajectory leaves (`.obs.agents_view`, `.action`,
...), trains a fresh ff actor by masked behaviour cloning (cross-entropy on
the recorded actions), and evaluates the cloned policy in the live
environment against the random baseline.

Usage (record a dataset first, then clone from it):

    python -m mava_jax.advanced_usage.ff_ippo_store_experience \
        env=rware env/scenario=tiny-2ag system.total_timesteps=2000000
    python examples/bc_from_vault.py vault_uid=<ts> env=rware \
        env/scenario=tiny-2ag bc_epochs=40

The vault directory is `vaults/<system_name>/<uid>` relative to the CWD of
the recording run. Named leaves require a vault written at round >= 3
(earlier vaults used positional leaf names).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from mava_jax import envs as environments
from mava_jax.evaluator import get_eval_fn, make_ff_eval_act_fn
from mava_jax.networks import FeedForwardActor as Actor
from mava_jax.networks.factory import make_action_head, make_torso
from mava_jax.parallel import make_mesh, num_learner_devices
from mava_jax.replay import Vault
from mava_jax.types import Observation
from mava_jax.utils.config import load_config

DEFAULTS = [
    "env=rware",
    "logger.use_console=False",
]


def load_dataset(vault_name: str, vault_uid: str):
    vault = Vault(vault_name=vault_name, vault_uid=vault_uid)
    data = vault.read()
    needed = [".obs.agents_view", ".obs.action_mask", ".obs.step_count", ".action"]
    missing = [k for k in needed if k not in data]
    if missing:
        raise SystemExit(
            f"vault {vault.base_dir} lacks named leaves {missing} — re-record "
            "with a current build (older vaults used positional leaf names)."
        )
    # (B, T, A, ...) -> flat (N, A, ...) supervised pairs.
    def flat(x):
        return x.reshape(-1, *x.shape[2:])

    obs = Observation(
        agents_view=flat(data[".obs.agents_view"]).astype(np.float32),
        action_mask=flat(data[".obs.action_mask"]),
        step_count=flat(data[".obs.step_count"]),
    )
    actions = flat(data[".action"]).astype(np.int32)
    return obs, actions


def main() -> float:
    kv = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    vault_uid = kv.pop("vault_uid", "")
    vault_name = kv.pop("vault_name", "ff_ippo_store_experience")
    epochs = int(kv.pop("bc_epochs", "20"))
    batch_size = int(kv.pop("bc_batch_size", "2048"))
    lr = float(kv.pop("bc_lr", "3e-4"))
    overrides = [f"{k}={v}" for k, v in kv.items()]

    cfg = load_config("default_ff_ippo", DEFAULTS + overrides)
    if not vault_uid:
        base = os.path.join("vaults", vault_name)
        uids = sorted(os.listdir(base)) if os.path.isdir(base) else []
        if not uids:
            raise SystemExit(f"no vaults under {base}; record one first.")
        vault_uid = uids[-1]

    obs, actions = load_dataset(vault_name, vault_uid)
    n = obs.agents_view.shape[0]
    print(f"dataset: {n:,} timesteps x {actions.shape[-1]} agents", flush=True)

    mesh = make_mesh()
    cfg.arch.n_devices = num_learner_devices(mesh)
    env, eval_env = environments.make(cfg)
    cfg.system.num_agents = env.num_agents

    actor = Actor(
        torso=make_torso(cfg.network.actor_network.pre_torso),
        action_head=make_action_head(cfg.network.action_head, env.action_dim),
    )
    init_obs = jax.tree.map(lambda x: x[:1], obs)
    key = jax.random.PRNGKey(cfg.system.seed)
    params = actor.init(key, init_obs)
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def bc_step(params, opt_state, batch_obs, batch_actions):
        def loss_fn(p):
            pi = actor.apply(p, batch_obs)
            return -jnp.mean(pi.log_prob(batch_actions))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    rng = np.random.default_rng(cfg.system.seed)
    steps_per_epoch = max(1, n // batch_size)
    for epoch in range(epochs):
        perm = rng.permutation(n)
        losses = []
        for i in range(steps_per_epoch):
            idx = perm[i * batch_size : (i + 1) * batch_size]
            batch_obs = jax.tree.map(lambda x: x[idx], obs)
            params, opt_state, loss = bc_step(params, opt_state, batch_obs, actions[idx])
            losses.append(float(loss))
        if epoch % max(1, epochs // 10) == 0 or epoch == epochs - 1:
            print(f"epoch {epoch}: bc loss {np.mean(losses):.4f}", flush=True)

    # Evaluate the cloned policy with the standard evaluator protocol.
    eval_act_fn = make_ff_eval_act_fn(actor.apply, cfg)
    evaluator = get_eval_fn(eval_env, eval_act_fn, cfg, mesh, absolute_metric=False)
    metrics = evaluator(params, jax.random.PRNGKey(123), {})
    ep_return = float(jnp.mean(metrics["episode_return"]))
    print(f"BC policy eval return: {ep_return:.3f} "
          f"(dataset {vault_name}/{vault_uid})", flush=True)
    return ep_return


if __name__ == "__main__":
    main()
