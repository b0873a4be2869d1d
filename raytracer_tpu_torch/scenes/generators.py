"""The three reference scenes (port of ``raytracer_tpu/scenes/generators.py``).

Reference: generateScene1 (src/main.cpp:583-716), generateScene2
(main.cpp:718-804), generateScene3 (main.cpp:1196-1229). Shape order,
positions, materials, camera and light match the reference; meshes are
deterministic procedural stand-ins with the same triangle counts
(scenes/meshgen.py) since the .obj payloads are absent from the reference
mount. The reference seeds its random spheres from std::random_device
(non-deterministic, main.cpp:932-953); we use a seeded numpy Generator so
renders are reproducible.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from raytracer_tpu_torch.core import camera as cam_ops
from raytracer_tpu_torch.core.scene import FlatScene, SceneBuilder
from raytracer_tpu_torch.core.types import Camera, Light, Material
from raytracer_tpu_torch.device import resolve_device
from raytracer_tpu_torch.scenes import meshgen


@dataclasses.dataclass
class Scene:
    """A fully assembled scene: flat arrays + camera + light + animation and
    BVH metadata (the equivalent of the reference's global ``scene`` struct,
    src/main.cpp:92-101)."""

    name: str
    flat: FlatScene
    camera: Camera
    light: Light
    bvh_max_depth: int
    animated_indices: List[int]
    # (shape_index, amplitude, frequency) triples for bounceSphere
    # (main.cpp:441-446).
    bounce_params: List[Tuple[int, float, float]]
    # wheel dicts: {"indices": [...], "center": (3,), "axis": (3,)}
    # (main.cpp:103-109, 757-782).
    wheels: List[Dict]

    @property
    def num_shapes(self) -> int:
        return self.flat.num_shapes


def _camera(position, aspect, look_at_target, device) -> Camera:
    cam = cam_ops.from_euler(position=position, fov_deg=60.0, aspect=aspect,
                             device=device)
    return cam_ops.look_at(cam, look_at_target)


def generate_scene1(aspect: float = 800.0 / 600.0, seed: int = 0,
                    device=None) -> Scene:
    """Scene 1 'monkeys' (main.cpp:583-716): 1240 shapes, BVH depth 15."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    # Animated bouncing spheres (main.cpp:594-616).
    b.add_sphere((0, 10, -8), 5.0, Material(color=(0, 0.37, 0), fresnel=0,
                 ambient=0.2, diffuse=1, specular=0.1), animated=True)
    b.add_sphere((12, 10, -8), 4.0, Material(color=(0.58, 0.18, 0.48),
                 fresnel=0, ambient=0, diffuse=0.5, specular=0),
                 animated=True)
    b.add_sphere((20, 7.5, -8), 2.5, Material(color=(0.8, 0.2, 0.8),
                 fresnel=1, ambient=0.06, diffuse=0.06, specular=0.5),
                 animated=True)
    b.add_sphere((0, 23, -8), 1.5, Material(color=(0, 0.37, 0), fresnel=0,
                 ambient=0, diffuse=0.5, specular=0))

    # Mirror wall (main.cpp:626-630); color stays at the default (1,1,1).
    b.add_wall((-15, 23, 10), 30, 20, (-1, 0.2, 0),
               Material(fresnel=1, ambient=0.1, diffuse=0, specular=1))

    # Free triangle with inverted normal (main.cpp:632-643).
    b.add_triangle((-15, 20, 25), (-12, 20, 10), (-15, 0, 20),
                   Material(color=(0.19, 0.66, 0.32), fresnel=1,
                            ambient=0.06, diffuse=0.06, specular=0.5),
                   invert_normal=True)

    # Monkey mesh at origin (0,0,-30) (main.cpp:645-662).
    monkey = meshgen.monkey_mesh()
    origin1 = np.array([0, 0, -30], np.float32)
    center1 = meshgen.mesh_center(monkey, origin1)
    b.add_triangles(monkey + origin1,
                    Material(color=(179 / 255, 165 / 255, 61 / 255),
                             fresnel=1, ambient=0.2, diffuse=0.8,
                             specular=0.1),
                    flip_toward_center=center1)

    # Low-poly monkey at (50,0,-30) (main.cpp:664-680).
    lowpoly = meshgen.lowpoly_monkey_mesh()
    origin2 = np.array([50, 0, -30], np.float32)
    center2 = meshgen.mesh_center(lowpoly, origin2)
    b.add_triangles(lowpoly + origin2,
                    Material(color=(0, 1, 0.9), fresnel=1, ambient=0.2,
                             diffuse=0.8, specular=0),
                    flip_toward_center=center2)

    # 25 random spheres at y=23 (main.cpp:684-695); material defaults apply.
    for _ in range(25):
        x = rng.uniform(-40, 40)
        z = rng.uniform(-40, 40)
        b.add_sphere((x, 23, z), 1.5,
                     Material(color=tuple(rng.uniform(0, 1, 3))))

    # Floor wall, n=(0,1,0): degenerate wall basis -> renders as an infinite
    # plane (see geom.direct.wall_basis; main.cpp:698-701).
    b.add_wall((-100, 25, -100), 210, 210, (0, 1, 0),
               Material(color=(0.65, 0.17, 0.35), specular=0))

    dev = resolve_device(device)
    flat = b.build(dev)
    assert flat.num_shapes == 1240, flat.num_shapes
    camera = _camera((30.0, -5.0, 40.0), aspect, (0, 10, -8), dev)
    light = Light((0, -14, 0), (1, 1, 1), 50.0, device=dev)
    return Scene("scene1_monkeys", flat, camera, light, bvh_max_depth=15,
                 animated_indices=b.animated_indices,
                 bounce_params=[(0, 10.0, 1.0), (1, 7.0, 0.8),
                                (2, 15.0, 1.5)],
                 wheels=[])


_WHEEL_CENTERS = [(-6.5, -1.6, 2.0), (6.5, -1.6, 2.0),
                  (-6.5, -1.6, -2.0), (6.5, -1.6, -2.0)]


def generate_scene2(aspect: float = 800.0 / 600.0, seed: int = 0,
                    device=None) -> Scene:
    """Scene 2 'car' (main.cpp:718-804): 4022 triangles + 100 spheres,
    rotating wheels, BVH depth 25."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    origin = np.zeros(3, np.float32)
    wheels: List[Dict] = []

    meshes = [meshgen.car_body_mesh()]
    for wc in _WHEEL_CENTERS:
        meshes.append(meshgen.wheel_mesh(np.asarray(wc, np.float32)))
    meshes.append(meshgen.road_mesh())

    materials = [
        Material(color=(19 / 255, 7 / 255, 92 / 255), specular=0),  # body
        Material(color=(0.2, 0.2, 0.2), specular=0),                # wheels
        Material(color=(0.2, 0.2, 0.2), specular=0),
        Material(color=(0.2, 0.2, 0.2), specular=0),
        Material(color=(0.2, 0.2, 0.2), specular=0),
        Material(color=(0, 0, 0), specular=0.25),                   # road
    ]

    for i, (mesh, mat) in enumerate(zip(meshes, materials)):
        center = meshgen.mesh_center(mesh, origin)
        animated = 1 <= i <= 4
        ids = b.add_triangles(mesh + origin, mat,
                              flip_toward_center=center, animated=animated)
        if animated:
            # Wheel center = mean over a+b+c of every wheel triangle
            # (main.cpp:771-781).
            tris = mesh + origin
            wc = tris.sum(axis=(0, 1)) / float(tris.shape[0] * 3)
            wheels.append({"indices": ids, "center": wc.astype(np.float32),
                           "axis": np.array([0, 0, 1], np.float32)})

    # 100 background spheres (main.cpp:788-795).
    for _ in range(100):
        x = rng.uniform(-30, 30)
        y = rng.uniform(-15, 0)
        b.add_sphere((x, y, -10), 1.5,
                     Material(color=tuple(rng.uniform(0, 1, 3))))

    dev = resolve_device(device)
    flat = b.build(dev)
    assert flat.num_shapes == 4122, flat.num_shapes
    camera = _camera((0.0, -10.0, 40.0), aspect, (0, 0, 0), dev)
    light = Light((14.8, -17, 17), (1, 1, 1), 26.0, device=dev)
    return Scene("scene2_car", flat, camera, light, bvh_max_depth=25,
                 animated_indices=b.animated_indices, bounce_params=[],
                 wheels=wheels)


def generate_scene3(aspect: float = 800.0 / 600.0, seed: int = 0,
                    device=None) -> Scene:
    """Scene 3 'triangle' (main.cpp:1196-1229): the minimal debug scene.
    The reference never builds a BVH for it (useBVH would index an empty
    node array — UB); we build a depth-0 trivial BVH instead."""
    b = SceneBuilder()
    b.add_triangle((0, 0, 0), (5, 0, 0), (2.5, -5, 0))
    dev = resolve_device(device)
    flat = b.build(dev)
    camera = _camera((0.0, -10.0, 40.0), aspect, (0, 0, 0), dev)
    light = Light((14.8, -17, 17), (1, 1, 1), 26.0, device=dev)
    return Scene("scene3_triangle", flat, camera, light, bvh_max_depth=0,
                 animated_indices=[], bounce_params=[], wheels=[])


_GENERATORS = {1: generate_scene1, 2: generate_scene2, 3: generate_scene3,
               "scene1": generate_scene1, "scene2": generate_scene2,
               "scene3": generate_scene3}


def generate_scene(which, aspect: float = 800.0 / 600.0,
                   seed: int = 0, device=None) -> Scene:
    """Compile-time SCENE selector equivalent (main.cpp:46)."""
    return _GENERATORS[which](aspect=aspect, seed=seed, device=device)
