"""Render one episode to an animated GIF — the reference quickstart's
`render_one_episode` (Jumanji viewer) as a first-class CLI on the native envs.

Rolls out a single unbatched eval environment on CPU with either a random
policy or an ff actor (freshly initialised, or restored from an orbax
checkpoint saved with `logger.checkpointing.save_model=True`), rendering
every state via `mava_jax/envs/render.py`.

Usage (config overrides compose exactly like the training CLIs):

    python examples/render_episode.py env=rware env/scenario=tiny-2ag
    python examples/render_episode.py env=cleaner network=cnn policy=fresh
    python examples/render_episode.py env=lbf policy=checkpoint \
        checkpoint_uid=<ts> out=results/render/lbf.gif

Supported envs: RWARE, LBF, Cleaner, MaConnector, SMAX, MaSwarm, Gigastep,
MaReacher, MaSwimmer, MaHopper, MaWalker, MaCheetah, MaAnt, MaHumanoid.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The viewer is a host-side tool: run on the CPU whatever accelerator exists.
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from mava_jax import envs as environments
from mava_jax.envs.render import rollout_episode, save_gif, unwrap_env
from mava_jax.utils.config import load_config

DEFAULTS = [
    "env=rware",  # its default scenario is tiny-2ag
    "logger.use_console=False",
]


def make_act_fn(cfg, env, policy: str, checkpoint_uid: str):
    base = unwrap_env(env)
    if policy == "random":
        from mava_jax import specs

        discrete = isinstance(base.action_spec(), specs.DiscreteArray)

        def random_act(timestep, key):
            if discrete:
                return jax.random.randint(key, (base.num_agents,), 0, base.action_dim)
            return jax.random.uniform(
                key, (base.num_agents, base.action_dim), minval=-1.0, maxval=1.0
            )

        return random_act

    # fresh / checkpoint: build actor+critic exactly as ff_ippo.learner_setup
    # does (the checkpoint item is the full Params tree, so the restore
    # template needs both even though only the actor acts).
    from mava_jax.networks import FeedForwardActor as Actor
    from mava_jax.networks import FeedForwardValueNet as Critic
    from mava_jax.networks.factory import make_action_head, make_torso
    from mava_jax.systems.ppo.types import Params

    cfg.system.num_agents = env.num_agents
    actor = Actor(
        torso=make_torso(cfg.network.actor_network.pre_torso),
        action_head=make_action_head(cfg.network.action_head, env.action_dim),
    )
    critic = Critic(torso=make_torso(cfg.network.critic_network.pre_torso))
    obs = env.observation_spec().generate_value()
    init_x = jax.tree.map(lambda x: x[jnp.newaxis, ...], obs)
    key_a, key_c = jax.random.split(jax.random.PRNGKey(cfg.system.seed))
    params = Params(actor.init(key_a, init_x), critic.init(key_c, init_x))

    if policy == "checkpoint":
        from mava_jax.utils.checkpointing import Checkpointer

        if not checkpoint_uid and not cfg.logger.checkpointing.load_args.get(
            "checkpoint_uid"
        ):
            raise SystemExit(
                "policy=checkpoint needs checkpoint_uid=<ts> (the timestamped "
                "run directory under checkpoints/) — without it the loader "
                "would create a fresh empty directory and find nothing."
            )
        loader = Checkpointer(
            model_name=cfg.logger.system_name,
            **{**cfg.logger.checkpointing.load_args,
               **({"checkpoint_uid": checkpoint_uid} if checkpoint_uid else {})},
        )
        restored, _ = loader.restore_params(params)
        params = restored
        loader.close()
    params = params.actor_params

    def act(timestep, key):
        pi = actor.apply(params, timestep.observation)
        return pi.mode()

    return act


def main() -> str:
    args = [a for a in sys.argv[1:] if "=" in a]
    kv = dict(a.split("=", 1) for a in args)
    policy = kv.pop("policy", "random")
    checkpoint_uid = kv.pop("checkpoint_uid", "")
    out = kv.pop("out", "")
    seed = int(kv.pop("render_seed", "0"))
    overrides = [f"{k}={v}" for k, v in kv.items()]

    cfg = load_config("default_ff_ippo", DEFAULTS + overrides)
    _, eval_env = environments.make(cfg)

    act_fn = make_act_fn(cfg, eval_env, policy, checkpoint_uid)
    frames, ep_return = rollout_episode(eval_env, act_fn, jax.random.PRNGKey(seed))

    if not out:
        os.makedirs("results/render", exist_ok=True)
        out = f"results/render/{cfg.env.env_name}_{policy}.gif"
    save_gif(frames, out)
    print(
        f"wrote {out}: {len(frames)} frames, episode return {ep_return:.2f} "
        f"({policy} policy)",
        flush=True,
    )
    return out


if __name__ == "__main__":
    main()
