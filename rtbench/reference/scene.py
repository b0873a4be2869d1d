"""The scene maker: a configuration's shape list, resolved from its seed
into shape arrays in the upstream's FlatShape layout (flatStructures.hpp:
22-53), the same arrays that the benchmark hands to the program.

A configuration file (``rtbench/configs/<name>.json``) lists its shapes
in the upstream's push order:

  {"kind": "sphere", "center", "radius"}
  {"kind": "wall", "start", "width", "height", "normal"}
  {"kind": "triangle", "p1", "p2", "p3", "invert_normal"}
  {"kind": "mesh", "mesh": <file under reference/meshes>, "args",
   "origin", "flip_toward_center"}
  {"kind": "random_spheres", "count", "position": [x, y, z], "radius"}

each with an optional "material" (the upstream's defaults fill the rest),
"animated" flag and "name" (a group the traffic can address). In
``random_spheres`` an axis given as [lo, hi] is drawn uniformly, in axis
order, then the colour from [0, 1)^3, sphere by sphere, from one NumPy
generator (main.cpp:684-695, 788-795) seeded with the configuration's
``scene_seed``, as the port's ``generate_scene(which, seed=scene_seed)``
draws them. With ``"recolor": true`` the run's seed then draws their
colours again: every run renders the same geometry (the same work) with
its own data.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

import numpy as np

SPHERE, PLANE, WALL, TRIANGLE = 0, 1, 2, 3

MATERIAL_DEFAULTS = {"color": [1.0, 1.0, 1.0], "fresnel": 1.0,
                     "ambient": 0.4, "diffuse": 1.0, "specular": 0.5,
                     "shininess": 32.0}

FIELDS3 = ("mat_color", "sphere_center", "plane_normal", "wall_start",
           "tri_p1", "tri_p2", "tri_p3", "origin")
FIELDS1 = ("mat_fresnel", "mat_ambient", "mat_diffuse", "mat_specular",
           "mat_shininess", "sphere_radius", "plane_d", "wall_width",
           "wall_height")


@dataclasses.dataclass
class Item:
    """One resolved push: a single shape, or a block of triangles."""

    kind: str                  # sphere | wall | triangle | triangles
    material: dict
    animated: bool
    name: str
    geom: dict                 # the kind's arguments, as arrays


@dataclasses.dataclass
class SceneSpec:
    items: List[Item]
    flat: Dict[str, np.ndarray]    # FlatShape columns, N rows
    groups: Dict[str, np.ndarray]  # name -> shape rows
    camera: dict                   # position, look_at, fov_deg
    light: dict                    # position, color, intensity
    bvh_max_depth: int

    @property
    def num_shapes(self) -> int:
        return int(self.flat["shape_type"].shape[0])


def mesh_center(tris: np.ndarray, origin) -> np.ndarray:
    """Mesh::center() (mesh.hpp:51-60) over the unique vertices."""
    verts = np.unique(tris.reshape(-1, 3).round(6), axis=0)
    origin = np.asarray(origin, np.float64)
    v = verts.shape[0]
    return ((origin + (origin + verts.astype(np.float64)).sum(0)) / v
            ).astype(np.float32)


def _material(spec) -> dict:
    out = dict(MATERIAL_DEFAULTS)
    out.update(spec or {})
    return out


def resolve(config: dict, seed: int) -> List[Item]:
    """The configuration's pushes with meshes built and random spheres
    drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    items: List[Item] = []
    for s in config["shapes"]:
        kind, name = s["kind"], s.get("name", "")
        mat, anim = _material(s.get("material")), bool(s.get("animated"))
        if kind == "mesh":
            mod = importlib.import_module(
                f"{__package__}.meshes.{s['mesh']}")
            tris = mod.make(**s.get("args", {}))
            origin = np.asarray(s.get("origin", [0, 0, 0]), np.float32)
            center = (mesh_center(tris, origin)
                      if s.get("flip_toward_center", True) else None)
            items.append(Item("triangles", mat, anim, name,
                              {"vertices": tris + origin,
                               "flip_toward_center": center}))
        elif kind == "random_spheres":
            for _ in range(int(s["count"])):
                pos = [float(rng.uniform(a[0], a[1]))
                       if isinstance(a, list) else float(a)
                       for a in s["position"]]
                m = dict(mat)
                m["color"] = [float(c) for c in rng.uniform(0, 1, 3)]
                items.append(Item("sphere", m, anim, name,
                                  {"center": pos, "radius": s["radius"]}))
        elif kind in ("sphere", "wall", "triangle"):
            geom = {k: v for k, v in s.items()
                    if k not in ("kind", "name", "material", "animated")}
            items.append(Item(kind, mat, anim, name, geom))
        else:
            raise ValueError(f"unknown shape kind {kind!r}")
    return items


def _row(n: int) -> Dict[str, np.ndarray]:
    cols = {f: np.zeros((n, 3), np.float32) for f in FIELDS3}
    cols.update({f: np.zeros(n, np.float32) for f in FIELDS1})
    cols["shape_type"] = np.zeros(n, np.int32)
    cols["animated"] = np.zeros(n, bool)
    return cols


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v)).astype(np.float32)


def flatten(items: List[Item]):
    """FlatShape columns (f32, shape_type int32, animated bool) and the
    named groups' rows. The plane fields follow the shape constructors
    (plane.hpp:28-33, wall.hpp:37-40, triangle.hpp:84-98, mesh.hpp:
    163-189)."""
    blocks, groups, n = [], {}, 0
    for it in items:
        if it.kind == "triangles":
            v = np.asarray(it.geom["vertices"], np.float64)
            p1, p2, p3 = v[:, 0], v[:, 1], v[:, 2]
            nrm = np.cross(p2 - p1, p3 - p1)
            ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = np.divide(nrm, ln, out=np.zeros_like(nrm), where=ln > 0)
            c = it.geom["flip_toward_center"]
            if c is not None:
                flip = (nrm @ np.asarray(c, np.float64)) > 0.0
                nrm = np.where(flip[:, None], -nrm, nrm)
            cols = _row(v.shape[0])
            cols["shape_type"][:] = TRIANGLE
            cols["plane_normal"][:] = nrm
            cols["plane_d"][:] = -(nrm * p1).sum(-1)
            cols["tri_p1"][:] = p1
            cols["tri_p2"][:] = p2
            cols["tri_p3"][:] = p3
            cols["origin"][:] = p1.astype(np.float32)
        else:
            cols = _row(1)
            g = it.geom
            if it.kind == "sphere":
                cols["shape_type"][0] = SPHERE
                cols["sphere_center"][0] = g["center"]
                cols["sphere_radius"][0] = g["radius"]
                cols["origin"][0] = g["center"]
            elif it.kind == "wall":
                nrm = _unit(g["normal"])
                start = np.asarray(g["start"], np.float32)
                cols["shape_type"][0] = WALL
                cols["plane_normal"][0] = nrm
                cols["plane_d"][0] = float(-np.dot(nrm, start))
                cols["wall_start"][0] = start
                cols["wall_width"][0] = g["width"]
                cols["wall_height"][0] = g["height"]
                cols["origin"][0] = start
            else:
                p = [np.asarray(g[k], np.float32) for k in ("p1", "p2", "p3")]
                nrm = np.cross((p[1] - p[0]).astype(np.float64),
                               (p[2] - p[0]).astype(np.float64))
                ln = np.linalg.norm(nrm)
                nrm = ((nrm / ln).astype(np.float32) if ln > 0
                       else np.zeros(3, np.float32))
                if g.get("invert_normal"):
                    nrm = -nrm
                cols["shape_type"][0] = TRIANGLE
                cols["plane_normal"][0] = nrm
                cols["plane_d"][0] = float(-np.dot(nrm.astype(np.float64),
                                                   p[0].astype(np.float64)))
                cols["tri_p1"][0], cols["tri_p2"][0] = p[0], p[1]
                cols["tri_p3"][0] = p[2]
                cols["origin"][0] = p[0]
        m = it.material
        cols["mat_color"][:] = np.asarray(m["color"], np.float32)
        for k in ("fresnel", "ambient", "diffuse", "specular", "shininess"):
            cols["mat_" + k][:] = float(m[k])
        cols["animated"][:] = it.animated
        rows = np.arange(n, n + cols["shape_type"].shape[0])
        if it.name:
            groups[it.name] = np.concatenate(
                [groups.get(it.name, np.zeros(0, np.int64)), rows])
        blocks.append(cols)
        n += rows.shape[0]
    flat = {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}
    return flat, groups


def recolor(config: dict, items: List[Item], run_seed: int) -> None:
    """New colours, drawn from the run's seed, for the random spheres of
    the groups marked ``recolor``."""
    groups = {s.get("name") for s in config["shapes"]
              if s["kind"] == "random_spheres" and s.get("recolor")}
    rng = np.random.default_rng([int(run_seed) & (2 ** 63 - 1), 4])
    for it in items:
        if it.kind == "sphere" and it.name in groups:
            it.material = dict(it.material,
                               color=[float(c) for c in rng.uniform(0, 1, 3)])


def make_scene(config: dict, run_seed=None, seed=None) -> SceneSpec:
    """The configuration's scene: drawn from ``seed`` (default the
    configuration's ``scene_seed``), recoloured from ``run_seed`` where
    given; checks its shape counts."""
    items = resolve(config, config["scene_seed"] if seed is None else seed)
    if run_seed is not None:
        recolor(config, items, run_seed)
    flat, groups = flatten(items)
    spec = SceneSpec(items, flat, groups, config["camera"], config["light"],
                     int(config["bvh_max_depth"]))
    want = config.get("counts", {})
    st = flat["shape_type"]
    got = {"shapes": int(st.shape[0]),
           "spheres": int((st == SPHERE).sum()),
           "walls": int((st == WALL).sum()),
           "triangles": int((st == TRIANGLE).sum())}
    for k, v in want.items():
        if got[k] != v:
            raise ValueError(f"{config['name']}: {got[k]} {k}, the "
                             f"configuration states {v}")
    return spec
