"""Lightweight YAML config system with group composition and CLI overrides.

Replaces the reference's Hydra + OmegaConf stack (`mava/configs/**`,
`@hydra.main` entry points, `mava/systems/ppo/ff_ippo.py:573-586`) — hydra is not
available in this image and a small explicit composer is easier to reason about.

Semantics:
  * A top-level file `configs/default_<system>.yaml` declares `defaults:` — a mapping of
    group name -> option. Each group option loads `configs/<group>/<option>.yaml` into
    `cfg.<group>`.
  * `env` group files may declare their own `defaults: {scenario: <name>}`, which loads
    `configs/env/scenario/<name>.yaml` into `cfg.env.scenario`.
  * Overrides: `group=option` recomposes a group; `env/scenario=name` (Hydra syntax,
    as in the reference CLI `README.md:170-183`) or `env.scenario=name` swaps the
    scenario file; any dotted path `a.b.c=value` sets an EXISTING leaf (value parsed
    as YAML) — unknown paths raise, `+a.b.c=value` adds a new key (Hydra's `+`).
  * The result is a `Config`: a dict with attribute access, open to new keys at
    runtime (the reference relies on OmegaConf struct-mode off for runtime-injected
    keys); strictness applies only to CLI overrides, where a typo must not pass
    silently.
"""

from __future__ import annotations

import copy
import re
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from mava_jax.utils import miniyaml

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"
# Persistent XLA compile cache when JAX_COMPILATION_CACHE_DIR is unset: a fixed
# directory inside the checkout, listed in .gitignore.
DEFAULT_COMPILATION_CACHE_DIR = CONFIG_DIR.parent.parent / ".jax_cache"


class Config(dict):
    """A dict with recursive attribute access. New keys may be added freely."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        out = Config()
        for k, v in d.items():
            out[k] = Config.from_dict(v) if isinstance(v, dict) else v
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()
        }


_NUMERIC_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _coerce_numbers(obj: Any) -> Any:
    """YAML 1.1 reads `1e5` as a string (no dot); OmegaConf-style configs expect a
    float. Coerce scientific-notation strings to floats recursively."""
    if isinstance(obj, dict):
        return {k: _coerce_numbers(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_coerce_numbers(v) for v in obj]
    if isinstance(obj, str) and _NUMERIC_RE.match(obj):
        return float(obj)
    return obj


def _load_yaml(path: Path) -> Dict[str, Any]:
    if not path.exists():
        raise FileNotFoundError(f"Config file not found: {path}")
    return _coerce_numbers(miniyaml.load(path.read_text()) or {})


def _load_group(group: str, option: str, config_dir: Path) -> Dict[str, Any]:
    """Load one group option; `option` may contain '/' for nested dirs
    (e.g. system: ppo/ff_ippo)."""
    data = _load_yaml(config_dir / group / f"{option}.yaml")
    # Nested defaults (currently only env -> scenario).
    inner_defaults = data.pop("defaults", None)
    if inner_defaults:
        for sub_group, sub_option in inner_defaults.items():
            data[sub_group] = _load_yaml(
                config_dir / group / sub_group / f"{sub_option}.yaml"
            )
    return data


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    for key, value in override.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, dict):
            _deep_merge(base[key], value)
        else:
            base[key] = value
    return base


def _parse_value(text: str) -> Any:
    return miniyaml.load(text)


def _set_dotted(
    cfg: Dict[str, Any], path: str, value: Any, allow_new: bool = False
) -> None:
    keys = path.split(".")
    node = cfg
    for i, key in enumerate(keys[:-1]):
        if key not in node or not isinstance(node[key], dict):
            if not allow_new:
                raise KeyError(
                    f"Override '{path}' refers to unknown config path "
                    f"'{'.'.join(keys[: i + 1])}'. Use '+{path}=...' to add new keys."
                )
            node[key] = Config()
        node = node[key]
    if not allow_new and keys[-1] not in node:
        raise KeyError(
            f"Override '{path}' refers to unknown config key '{keys[-1]}'. "
            f"Use '+{path}=...' to add new keys."
        )
    node[keys[-1]] = value


_cache_enabled = False


def _host_cpu_fingerprint() -> str:
    """Short hash of this host's CPU identity. XLA:CPU AOT executables embed
    ISA + TUNING features of the machine that COMPILED them; loading one on a
    different host can SIGILL/segfault (the cpu_aot_loader warns exactly
    this). Scoping the CPU cache per fingerprint makes stale cross-host
    entries unreachable instead of fatal.

    The hash covers `model name` and `microcode` in addition to the feature
    `flags`: LLVM derives tuning features like `+prefer-no-gather` from the
    CPU model/microcode (gather-mitigation state), so two hosts with
    identical cpuinfo FLAGS can still disagree on the compiled feature set —
    observed Aug 2026 when a container respawned on a same-family host and
    the flags-only fingerprint collided."""
    import hashlib

    try:
        picked = {}
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("flags", "model name", "microcode") and key not in picked:
                    picked[key] = " ".join(sorted(line.split(":", 1)[1].split()))
        if picked:
            ident = "|".join(f"{k}={picked[k]}" for k in sorted(picked))
            return hashlib.md5(ident.encode()).hexdigest()[:12]
    except OSError:  # pragma: no cover - non-linux
        pass
    import platform

    return hashlib.md5(platform.processor().encode()).hexdigest()[:12]


def enable_persistent_compilation_cache() -> None:
    """Turn on JAX's persistent compilation cache (idempotent).

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already keeps its cache
    there and no other directory is set here. Otherwise the cache sits at
    DEFAULT_COMPILATION_CACHE_DIR, a fixed path inside the checkout (the path
    is part of what makes a later run find the entries). Processes that force
    the CPU backend (tests, virtual meshes) use a per-CPU-fingerprint
    subdirectory of it: XLA:CPU AOT results are host-ISA-specific and can
    crash when reused on another machine. Opt out with
    MAVA_NO_COMPILATION_CACHE=1.
    """
    global _cache_enabled
    if _cache_enabled or os.environ.get("MAVA_NO_COMPILATION_CACHE"):
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        cache_dir = DEFAULT_COMPILATION_CACHE_DIR
        if "cpu" in str(jax.config.jax_platforms or ""):
            cache_dir = cache_dir / f"cpu-{_host_cpu_fingerprint()}"
        jax.config.update("jax_compilation_cache_dir", str(cache_dir))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    _cache_enabled = True


def load_config(
    default_name: str,
    overrides: Optional[Sequence[str]] = None,
    config_dir: Optional[os.PathLike] = None,
) -> Config:
    """Compose a config from `configs/<default_name>.yaml` plus CLI-style overrides."""
    config_dir = Path(config_dir) if config_dir is not None else CONFIG_DIR
    top = _load_yaml(config_dir / f"{default_name}.yaml")
    defaults: Dict[str, str] = top.pop("defaults", {})

    # Group switches in the overrides replace the default option before composing.
    overrides = list(overrides or [])
    if any(ov in ("--help", "-h", "help") for ov in overrides):
        lines = [
            f"Usage: python -m mava_jax.systems.<family>.<system> [group=option ...]"
            f" [a.b.c=value ...]",
            "",
            f"Defaults ({default_name}.yaml):",
        ]
        for group, option in defaults.items():
            choices = sorted(
                str(p.relative_to(config_dir / group)).removesuffix(".yaml")
                for p in (config_dir / group).glob("**/*.yaml")
                if p.parent.name != "scenario"
            )
            lines.append(f"  {group}={option}    (choices: {', '.join(choices)})")
        scen_dir = config_dir / "env" / "scenario"
        if scen_dir.is_dir():
            lines.append(
                "  env/scenario=<name>    (choices: "
                + ", ".join(sorted(p.stem for p in scen_dir.glob("*.yaml")))
                + ")"
            )
        lines += [
            "",
            "Leaf overrides set EXISTING keys (strict): system.seed=7,"
            " arch.num_envs=256, system.total_timesteps=20000000 ...",
            "Add new keys with a leading '+': +system.my_flag=1",
        ]
        print("\n".join(lines))
        raise SystemExit(0)
    # After the (jax-free) help path: point JAX at the persistent compile cache.
    enable_persistent_compilation_cache()
    remaining: List[str] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value, got: {ov}")
        key, value = ov.split("=", 1)
        if key in defaults and "." not in key:
            defaults[key] = value
        else:
            remaining.append(ov)

    cfg: Dict[str, Any] = {}
    for group, option in defaults.items():
        cfg[group] = _load_group(group, str(option), config_dir)
    _deep_merge(cfg, top)  # top-level keys outside `defaults` overlay the groups

    # Sub-group swaps: Hydra syntax `env/scenario=name`, plus `env.scenario=name`
    # kept as an explicit alias. Dotted keys are otherwise ALWAYS leaf overrides —
    # deriving swaps from dots would silently hijack keys like `system.ppo=...`
    # whenever they happen to name a config subdirectory.
    leaf_overrides: List[str] = []
    for ov in remaining:
        key, value = ov.split("=", 1)
        if key == "env.scenario":
            key = "env/scenario"
        if "/" in key:
            group, sub = key.split("/", 1)
            if not (config_dir / group / sub).is_dir():
                raise KeyError(
                    f"Override '{ov}' looks like a group swap but "
                    f"'{config_dir / group / sub}' is not a config group directory."
                )
            if group not in cfg:
                raise KeyError(
                    f"Override '{ov}' targets group '{group}' which is not part "
                    f"of this config's defaults."
                )
            cfg[group][sub] = _load_yaml(config_dir / group / sub / f"{value}.yaml")
            continue
        leaf_overrides.append(ov)

    for ov in leaf_overrides:
        key, value = ov.split("=", 1)
        allow_new = key.startswith("+")
        _set_dotted(cfg, key.lstrip("+"), _parse_value(value), allow_new=allow_new)

    return Config.from_dict(cfg)
