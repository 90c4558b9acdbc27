"""The main path needs only JAX and the packages sure to be next to it (numpy,
optax, chex): a tiny ff-IPPO run_experiment succeeds with flax, PyYAML,
colorama, orbax and PIL blocked from import."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

BLOCKED = ("flax", "yaml", "colorama", "orbax", "PIL")

SCRIPT = textwrap.dedent(
    """
    import importlib.abc
    import sys

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked for this test: {{name}}")

    sys.meta_path.insert(0, Block())
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]

    import jax
    jax.config.update("jax_platforms", "cpu")

    from mava_jax.systems.ppo import ff_ippo
    from mava_jax.utils.config import load_config

    cfg = load_config("default_ff_ippo", [
        "system.num_updates=2", "arch.num_evaluation=1", "system.rollout_length=4",
        "arch.num_envs=2", "arch.num_eval_episodes=2", "arch.absolute_metric=False",
        "system.ppo_epochs=1", "env.kwargs.time_limit=8",
    ])
    perf = ff_ippo.run_experiment(cfg)
    assert not any(name.split(".")[0] in BLOCKED for name in sys.modules), sorted(
        name for name in sys.modules if name.split(".")[0] in BLOCKED
    )
    print("MAIN_PATH_OK", perf)
    """
)


def test_ff_ippo_runs_with_optional_packages_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO), MAVA_NO_COMPILATION_CACHE="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(blocked=BLOCKED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "MAIN_PATH_OK" in proc.stdout
