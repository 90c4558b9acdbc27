"""examples/Quickstart.ipynb executes end-to-end (shrunken config) — the
literal-parity counterpart of the reference's notebook must stay runnable."""

import os

import pytest

nbformat = pytest.importorskip("nbformat")
pytest.importorskip("nbclient")
from nbclient import NotebookClient  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB = os.path.join(REPO, "examples", "Quickstart.ipynb")

TINY = """
    [
        "env=lbf",
        "env/scenario=2s-8x8-2p-2f-coop",
        "env.kwargs.time_limit=16",
        "arch.num_envs=2",
        "system.rollout_length=4",
        "system.total_timesteps=64",
        "arch.num_evaluation=2",
        "arch.num_eval_episodes=8",
        "+system.ppo_epochs=1",
        "+system.num_minibatches=2",
        "logger.use_console=False",
    ],
"""


def test_quickstart_notebook_executes():
    nb = nbformat.read(NB, as_version=4)

    patched = cpu_forced = False
    for cell in nb.cells:
        if cell.cell_type != "code":
            continue
        if "total_timesteps=300000" in cell.source:
            start = cell.source.index("[")
            end = cell.source.index("]") + 2  # include "],"
            cell.source = cell.source[:start] + TINY.strip() + cell.source[end:]
            patched = True
        if '# jax.config.update("jax_platforms", "cpu")' in cell.source:
            # The kernel is a separate process: conftest's in-process CPU
            # selection doesn't reach it, and on a machine with a GPU the test
            # must not grab the card. Uncomment the notebook's own CPU line.
            cell.source = cell.source.replace(
                '# jax.config.update("jax_platforms", "cpu")',
                'jax.config.update("jax_platforms", "cpu")',
            )
            cpu_forced = True
    assert patched, "config cell not found — notebook layout changed"
    assert cpu_forced, "CPU-selection line not found — notebook layout changed"

    client = NotebookClient(
        nb, timeout=600, kernel_name="python3", resources={"metadata": {"path": REPO}}
    )
    client.execute()

    # The training cell printed eval lines and the render cell wrote a GIF.
    out_text = "".join(
        "".join(o.get("text", "") for o in c.get("outputs", []) if o.get("output_type") == "stream")
        for c in nb.cells
        if c.cell_type == "code"
    )
    assert "eval return" in out_text
    assert "wrote results/render/quickstart_lbf.gif" in out_text
