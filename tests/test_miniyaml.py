"""The in-repo YAML loader against PyYAML on every shipped config and on the
scalar forms CLI overrides use."""

from pathlib import Path

import pytest

from mava_jax.utils import miniyaml
from mava_jax.utils.config import CONFIG_DIR

CONFIGS = sorted(str(p.relative_to(CONFIG_DIR)) for p in CONFIG_DIR.glob("**/*.yaml"))


@pytest.fixture(scope="module")
def pyyaml():
    return pytest.importorskip("yaml")


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_config_matches_pyyaml(name, pyyaml):
    text = (CONFIG_DIR / name).read_text()
    assert miniyaml.load(text) == pyyaml.safe_load(text)


@pytest.mark.parametrize(
    "text",
    [
        "True", "false", "yes", "Off", "~", "null", "", "3", "-2", "1_000",
        "0.5", "3.0e-4", "1e-4", "1e5", ".inf", "-.inf", "foo", "a:b",
        "'quoted # not a comment'", '"tab\\tand\\nnewline"', "'it''s'",
        "[128, 128]", "[a, 'b c', 1.5, [2, 3], []]", "{}", "{a: 1, b: [1, 2]}",
        "key: value  # trailing comment",
        "a:\n  b:\n    c: 1\n  d: [1, 2]\ne: ~\n",
        "list:\n  - [1, 2]\n  - [3, 4]\nafter: 1\n",
        "list:\n- x\n- 2\n",
        "# only a comment\n",
    ],
)
def test_values_match_pyyaml(text, pyyaml):
    assert miniyaml.load(text) == pyyaml.safe_load(text)


@pytest.mark.parametrize(
    "text",
    [
        "a: &anchor 1\nb: *anchor\n",
        "a: !!str 1\n",
        "a: |\n  block\n",
        "a: 1\n---\nb: 2\n",
        "a:\n\tb: 1\n",
        "a:\n  - b: 1\n",
        "a: [1, 2\n",
    ],
)
def test_unsupported_syntax_is_refused(text):
    with pytest.raises(ValueError):
        miniyaml.load(text)


def test_bad_indentation_is_refused():
    with pytest.raises(ValueError):
        miniyaml.load("a:\n    b: 1\n  c: 2\n")


def test_config_loads_without_pyyaml(tmp_path: Path):
    """load_config composes through the in-repo loader (scientific notation
    still coerced to float, as before)."""
    from mava_jax.utils.config import load_config

    cfg = load_config("default_ff_ippo", ["system.actor_lr=3.0e-4"])
    assert cfg.system.actor_lr == pytest.approx(3e-4)
    assert cfg.network.actor_network.pre_torso.layer_sizes == [128, 128]
