"""Episode rendering: turn env states into RGB frames / animated GIFs.

The reference gets rendering from its external env suites (Jumanji viewers —
its `examples/Quickstart.ipynb` ends by animating a trained RWARE episode via
`jumanji.make(...).render`); this framework ships native env engines, so it
ships the native viewers too. Pure numpy + PIL raster drawing (no matplotlib
dependency in the render path), one renderer per env family:

* grid worlds  — RWARE (shelves/goals/carriers), LBF (food levels),
  Cleaner (dirty mask), MaConnector (trails/targets)
* continuous   — SMAX (unit discs, hp ring, ally/enemy), MaSwarm
  (agents + landmarks)

Frames are plain `np.uint8 (H, W, 3)` arrays; `save_gif` writes an animated
GIF. `rollout_episode` drives ONE unbatched eval env on CPU with any act fn
(random, fresh, or checkpoint-restored policy — see `examples/render_episode.py`).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Agent palette (distinct, colourblind-safe-ish).
AGENT_COLORS = [
    (31, 119, 180),
    (255, 127, 14),
    (44, 160, 44),
    (214, 39, 40),
    (148, 103, 189),
    (140, 86, 75),
    (227, 119, 194),
    (127, 127, 127),
    (188, 189, 34),
    (23, 190, 207),
]

BG = (250, 250, 250)
GRID_LINE = (225, 225, 225)


def unwrap_env(env: Any) -> Any:
    """Follow the wrapper chain to the base engine."""
    while hasattr(env, "_env"):
        env = env._env
    return env


def unwrap_state(state: Any) -> Any:
    """Follow wrapper states (e.g. RecordEpisodeMetricsState) to the base state."""
    while hasattr(state, "env_state"):
        state = state.env_state
    return state


def _canvas(rows: int, cols: int, scale: int):
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (cols * scale, rows * scale), BG)
    draw = ImageDraw.Draw(img)
    for r in range(rows + 1):
        draw.line([(0, r * scale), (cols * scale, r * scale)], fill=GRID_LINE)
    for c in range(cols + 1):
        draw.line([(c * scale, 0), (c * scale, rows * scale)], fill=GRID_LINE)
    return img, draw


def _cell(draw, r: int, c: int, scale: int, color, inset: int = 1) -> None:
    draw.rectangle(
        [c * scale + inset, r * scale + inset,
         (c + 1) * scale - inset, (r + 1) * scale - inset],
        fill=color,
    )


def _disc(draw, r: float, c: float, scale: int, color, shrink: float = 0.12,
          outline=None) -> None:
    pad = scale * shrink
    draw.ellipse(
        [c * scale + pad, r * scale + pad,
         (c + 1) * scale - pad, (r + 1) * scale - pad],
        fill=color,
        outline=outline,
        width=2 if outline else 0,
    )


def _text(draw, r: float, c: float, scale: int, s: str, color=(255, 255, 255)):
    draw.text((c * scale + scale * 0.36, r * scale + scale * 0.22), s, fill=color)


def _render_rware(env: Any, state: Any, scale: int = 32) -> np.ndarray:
    img, draw = _canvas(env.height, env.width, scale)
    storage = np.asarray(env._storage_mask)
    goals = np.asarray(env._goals)
    shelf_pos = np.asarray(state.shelf_pos)
    requested = np.asarray(state.shelf_requested)
    agent_pos = np.asarray(state.agent_pos)
    carrying = np.asarray(state.agent_carrying)

    for r, c in np.argwhere(storage):
        _cell(draw, r, c, scale, (235, 235, 235))
    for r, c in goals:
        _cell(draw, r, c, scale, (180, 220, 180))
    # Shelves whose id is carried ride on the agent; draw them at shelf_pos anyway
    # (the engine keeps shelf_pos synced to the carrier's cell).
    for sid, (r, c) in enumerate(shelf_pos):
        color = (240, 150, 60) if requested[sid] else (120, 120, 130)
        _cell(draw, r, c, scale, color, inset=scale // 5)
    for aid, (r, c) in enumerate(agent_pos):
        _disc(draw, r, c, scale, AGENT_COLORS[aid % len(AGENT_COLORS)],
              outline=(60, 20, 90) if carrying[aid] >= 0 else None)
    return np.asarray(img)


def _render_lbf(env: Any, state: Any, scale: int = 32) -> np.ndarray:
    img, draw = _canvas(env.grid_size, env.grid_size, scale)
    food_pos = np.asarray(state.food_pos)
    food_level = np.asarray(state.food_level)
    eaten = np.asarray(state.food_eaten)
    agent_pos = np.asarray(state.agent_pos)
    agent_level = np.asarray(state.agent_level)

    for fid, (r, c) in enumerate(food_pos):
        if eaten[fid]:
            continue
        _disc(draw, r, c, scale, (80, 160, 60), shrink=0.2)
        _text(draw, r, c, scale, str(int(food_level[fid])))
    for aid, (r, c) in enumerate(agent_pos):
        _disc(draw, r, c, scale, AGENT_COLORS[aid % len(AGENT_COLORS)])
        _text(draw, r, c, scale, str(int(agent_level[aid])))
    return np.asarray(img)


def _render_cleaner(env: Any, state: Any, scale: int = 32) -> np.ndarray:
    img, draw = _canvas(env.num_rows, env.num_cols, scale)
    dirty = np.asarray(state.dirty)
    for r, c in np.argwhere(dirty):
        _cell(draw, r, c, scale, (150, 110, 70))
    for aid, (r, c) in enumerate(np.asarray(state.agent_pos)):
        _disc(draw, r, c, scale, AGENT_COLORS[aid % len(AGENT_COLORS)])
    return np.asarray(img)


def _render_connector(env: Any, state: Any, scale: int = 32) -> np.ndarray:
    img, draw = _canvas(env.grid_size, env.grid_size, scale)
    for r, c in np.argwhere(np.asarray(state.paths)):
        _cell(draw, r, c, scale, (205, 205, 215))
    connected = np.asarray(state.connected)
    for aid, (r, c) in enumerate(np.asarray(state.target_pos)):
        color = AGENT_COLORS[aid % len(AGENT_COLORS)]
        _cell(draw, r, c, scale, tuple(min(255, v + 80) for v in color),
              inset=scale // 4)
    for aid, (r, c) in enumerate(np.asarray(state.head_pos)):
        _disc(draw, r, c, scale, AGENT_COLORS[aid % len(AGENT_COLORS)],
              outline=(30, 120, 30) if connected[aid] else None)
    return np.asarray(img)


def _render_smax(env: Any, state: Any, scale: int = 18) -> np.ndarray:
    from mava_jax.envs.smax import MAP_HEIGHT, MAP_WIDTH

    img, draw = _canvas(int(MAP_HEIGHT), int(MAP_WIDTH), scale)
    pos = np.asarray(state.unit_pos)  # (N, 2) as (x, y)
    hp = np.asarray(state.unit_hp)
    max_hp = np.asarray(env._stats[np.asarray(state.unit_types), 0])
    n_allies = env.num_agents
    for i in range(pos.shape[0]):
        if hp[i] <= 0:
            continue
        x, y = pos[i]
        ally = i < n_allies
        frac = float(np.clip(hp[i] / max(max_hp[i], 1e-6), 0.0, 1.0))
        base = (40, 90, 200) if ally else (200, 60, 50)
        color = tuple(int(v * (0.45 + 0.55 * frac)) for v in base)
        # y grows upward in SMAX; image rows grow downward.
        _disc(draw, MAP_HEIGHT - 1 - y, x, scale, color,
              outline=(20, 20, 20) if ally else None)
    return np.asarray(img)


def _render_maswarm(env: Any, state: Any, scale: int = 60) -> np.ndarray:
    # Positions live roughly in [-1.5, 1.5]^2 — map to a 10x10 cell canvas.
    cells, lo, hi = 10, -1.5, 1.5
    img, draw = _canvas(cells, cells, scale)

    def to_cell(p):
        return (np.clip((p - lo) / (hi - lo), 0, 0.999) * cells)

    # y grows upward in the arena; image rows grow downward.
    for p in np.asarray(state.landmarks):
        cx, cy = to_cell(np.asarray(p))
        _disc(draw, cells - cy - 0.5, cx - 0.5, scale, (120, 170, 120), shrink=0.33)
    for aid, p in enumerate(np.asarray(state.pos)):
        cx, cy = to_cell(np.asarray(p))
        _disc(draw, cells - cy - 0.5, cx - 0.5, scale,
              AGENT_COLORS[aid % len(AGENT_COLORS)], shrink=0.28)
    return np.asarray(img)


def _line(draw, p0, p1, color, width=4):
    draw.line([tuple(p0), tuple(p1)], fill=color, width=width)


def _planar_segments(env: Any, q) -> Tuple[np.ndarray, np.ndarray]:
    """((L,2) starts, (L,2) steps) world-frame link segments for the planar
    articulated engines (chain via _body_frame, trees via _frames)."""
    if hasattr(env, "_frames"):  # branched topology (cheetah/walker)
        starts, steps, _ = env._frames(q)
        return np.asarray(starts), np.asarray(steps)
    centers, phi = env._body_frame(q)  # chain (hopper/swimmer)
    u = jnp.stack([jnp.cos(phi), jnp.sin(phi)], axis=-1)
    steps = env.link_lengths[:, None] * u
    return np.asarray(centers - 0.5 * steps), np.asarray(steps)


def _joint_agent_colors(env: Any, n_links: int) -> list:
    """Colour link i by the agent owning joint i-1 (link 0 = torso, grey)."""
    jpa = getattr(env, "joints_per_agent", 1)
    colors = [(90, 90, 100)]
    for j in range(n_links - 1):
        colors.append(AGENT_COLORS[(j // jpa) % len(AGENT_COLORS)])
    return colors


def _render_planar_locomotion(env: Any, state: Any, scale: int = 60) -> np.ndarray:
    """Side-view stick figure for hopper/walker/cheetah/swimmer: camera tracks
    the base, ground line at y=0, links coloured by owning agent."""
    from PIL import Image, ImageDraw

    W, H = 480, 360
    img = Image.new("RGB", (W, H), BG)
    draw = ImageDraw.Draw(img)
    q = jnp.asarray(state.q)
    starts, steps = _planar_segments(env, q)
    base = np.asarray(q[:2])

    def to_px(p):
        return (W / 2 + (p[0] - base[0]) * scale, H * 0.8 - p[1] * scale)

    draw.line([(0, H * 0.8), (W, H * 0.8)], fill=(160, 160, 160), width=2)
    colors = _joint_agent_colors(env, starts.shape[0])
    for i in range(starts.shape[0]):
        _line(draw, to_px(starts[i]), to_px(starts[i] + steps[i]), colors[i], width=6)
    ex, ey = to_px(base)
    draw.ellipse([ex - 5, ey - 5, ex + 5, ey + 5], fill=(30, 30, 30))
    return np.asarray(img)


def _render_mareacher(env: Any, state: Any, scale: int = 140) -> np.ndarray:
    from PIL import Image, ImageDraw

    W = H = 400
    img = Image.new("RGB", (W, H), BG)
    draw = ImageDraw.Draw(img)

    def to_px(p):
        return (W / 2 + p[0] * scale, H / 2 - p[1] * scale)

    q = jnp.asarray(state.q)
    phi = jnp.cumsum(q)
    u = jnp.stack([jnp.cos(phi), jnp.sin(phi)], axis=-1)
    ends = np.asarray(jnp.cumsum(env.link_lengths[:, None] * u, axis=0))
    pts = np.concatenate([np.zeros((1, 2)), ends], axis=0)
    tx, ty = to_px(np.asarray(state.target))
    draw.ellipse([tx - 8, ty - 8, tx + 8, ty + 8], fill=(200, 60, 50))
    jpa = getattr(env, "joints_per_agent", 1)
    for i in range(pts.shape[0] - 1):
        color = AGENT_COLORS[(i // jpa) % len(AGENT_COLORS)]
        _line(draw, to_px(pts[i]), to_px(pts[i + 1]), color, width=7)
    return np.asarray(img)


def _render_pointcloud3d(env: Any, state: Any, scale: int = 90) -> np.ndarray:
    """Side-view orthographic projection (x right, z up) of the 3D point-cloud
    engines (MaAnt/MaHumanoid): mass points as discs, ground shadow."""
    from PIL import Image, ImageDraw

    W, H = 480, 360
    img = Image.new("RGB", (W, H), BG)
    draw = ImageDraw.Draw(img)
    q = jnp.asarray(state.q)
    pts = np.asarray(env._points(q))  # (P, 3)
    cx = float(q[0])

    def to_px(x, z):
        return (W / 2 + (x - cx) * scale, H * 0.85 - z * scale)

    draw.line([(0, H * 0.85), (W, H * 0.85)], fill=(160, 160, 160), width=2)
    order = np.argsort(pts[:, 1])  # far (small y) first
    for i in order:
        x, y, z = pts[i]
        px, py = to_px(x, z)
        r = 4 + 2 * (y - pts[:, 1].min()) / (np.ptp(pts[:, 1]) + 1e-6)
        shade = int(140 - 60 * (y - pts[:, 1].min()) / (np.ptp(pts[:, 1]) + 1e-6))
        draw.ellipse([px - r, py - r, px + r, py + r], fill=(shade, shade, 200))
    return np.asarray(img)


def _render_gigastep(env: Any, state: Any, scale: int = 44) -> np.ndarray:
    from mava_jax.envs.gigastep import _ARENA

    img, draw = _canvas(int(_ARENA), int(_ARENA), scale)
    wx, wy = np.asarray(state.waypoint)
    if getattr(env, "scenario", "") == "waypoint":
        _disc(draw, _ARENA - 1 - wy, wx, scale, (120, 170, 120), shrink=0.25)
    for team, active, color in (
        (np.asarray(state.team_pos), np.asarray(state.team_active), (40, 90, 200)),
        (np.asarray(state.adv_pos), np.asarray(state.adv_active), (200, 60, 50)),
    ):
        for i in range(team.shape[0]):
            if not active[i]:
                continue
            x, y = team[i]
            _disc(draw, _ARENA - 1 - y, x, scale, color, shrink=0.3)
    return np.asarray(img)


_RENDERERS = {
    "RobotWarehouse": _render_rware,
    "LevelBasedForaging": _render_lbf,
    "Cleaner": _render_cleaner,
    "MaConnector": _render_connector,
    "Smax": _render_smax,
    "MaSwarm": _render_maswarm,
    "MaReacher": _render_mareacher,
    "MaSwimmer": _render_planar_locomotion,
    "MaHopper": _render_planar_locomotion,
    "MaWalker": _render_planar_locomotion,
    "MaCheetah": _render_planar_locomotion,
    "MaAnt": _render_pointcloud3d,
    "MaHumanoid": _render_pointcloud3d,
    "Gigastep": _render_gigastep,
}


def render_frame(env: Any, state: Any) -> np.ndarray:
    """Render one env state to an RGB uint8 frame. Raises KeyError for env
    families without a registered viewer (only matrax — a matrix game with no
    spatial state)."""
    base_env = unwrap_env(env)
    name = type(base_env).__name__
    if name not in _RENDERERS:
        raise KeyError(
            f"no renderer registered for {name!r} "
            f"(available: {sorted(_RENDERERS)})"
        )
    return _RENDERERS[name](base_env, unwrap_state(state))


def rollout_episode(
    env: Any,
    act_fn: Callable[[Any, jnp.ndarray], jnp.ndarray],
    key: jnp.ndarray,
    max_steps: Optional[int] = None,
) -> Tuple[List[np.ndarray], float]:
    """Roll out ONE unbatched episode, rendering every state.

    `act_fn(timestep, key) -> (A,) actions`. Returns (frames, episode_return).
    Plain python loop — this is a viewer, not a training path.
    """
    max_steps = max_steps or getattr(unwrap_env(env), "time_limit", 200)
    state, timestep = env.reset(key)
    frames = [render_frame(env, state)]
    total = 0.0
    step = jax.jit(env.step)  # eager articulated dynamics are seconds per step
    for _ in range(max_steps):
        key, act_key = jax.random.split(key)
        action = act_fn(timestep, act_key)
        state, timestep = step(state, action)
        frames.append(render_frame(env, state))
        total += float(np.asarray(timestep.reward).mean())
        if bool(np.asarray(timestep.last())):
            break
    return frames, total


def save_gif(frames: List[np.ndarray], path: str, fps: int = 8) -> str:
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(
        path,
        save_all=True,
        append_images=imgs[1:],
        duration=int(1000 / fps),
        loop=0,
    )
    return path
