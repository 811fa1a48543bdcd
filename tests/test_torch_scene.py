"""The port's host layer and DeviceScene against the JAX package.

Parsing and packing are numpy code copied from the JAX package, so every
array must be identical.  ``DeviceScene`` is the same per-component form as
tensors, built either from the port's own ScenePack (``from_pack``) or
from the JAX scene's fields (``from_numpy``); both must equal the JAX
scene exactly.  The port must not import jax anywhere.
"""

import ast
import dataclasses
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu.models.device_scene import (
    DeviceScene as JaxDeviceScene)
from pathtracer_cuda_interactive_tpu.models.scenepack import (
    load_scene as jax_load_scene)
import pathtracer_cuda_interactive_tpu_torch as port
from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
    DeviceScene)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import (
    ScenePack, load_scene)
from pathtracer_cuda_interactive_tpu_torch.ops import integrator
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)

SCENES = ["spheres", "cbox_rect", "pointlight"]


def _mesh_scene(tmp_path) -> str:
    """An OBJ mesh (a quad with normals and uvs, a triangle without), a
    sphere and a point light, written into tmp_path."""
    (tmp_path / "mesh.obj").write_text(textwrap.dedent("""\
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        vt 0 0
        vt 1 0
        vt 1 1
        vt 0 1
        vn 0 0 1
        f 1/1/1 2/2/1 3/3/1 4/4/1
        """))
    (tmp_path / "tri.obj").write_text("v 0 0 1\nv 1 0 1\nv 0 1 2\nf 1 2 3\n")
    xml = tmp_path / "scene.xml"
    xml.write_text(textwrap.dedent("""\
        <scene version="0.6.0">
          <sensor type="perspective">
            <float name="fov" value="50"/>
            <transform name="toWorld">
              <lookat origin="0.5, 0.5, 4" target="0.5, 0.5, 0" up="0, 1, 0"/>
            </transform>
            <film type="hdrfilm">
              <integer name="width" value="32"/>
              <integer name="height" value="24"/>
            </film>
          </sensor>
          <bsdf type="phong" id="a"><float name="exponent" value="12"/></bsdf>
          <bsdf type="plastic" id="b"><float name="eta" value="1.4"/></bsdf>
          <emitter type="point">
            <point name="position" x="0" y="2" z="2"/>
            <rgb name="intensity" value="3, 2, 1"/>
          </emitter>
          <shape type="obj">
            <string name="filename" value="mesh.obj"/>
            <transform name="toWorld"><rotate y="1" angle="10"/></transform>
            <ref id="a"/>
          </shape>
          <shape type="obj">
            <string name="filename" value="tri.obj"/>
            <ref id="b"/>
            <emitter type="area"><rgb name="radiance" value="1, 1, 1"/></emitter>
          </shape>
          <shape type="sphere">
            <point name="center" x="0.5" y="0.5" z="-1"/>
            <float name="radius" value="0.5"/>
            <ref id="b"/>
          </shape>
        </scene>
        """))
    return str(xml)


@pytest.fixture(params=SCENES + ["obj_mesh"])
def scene_path(request, tmp_path):
    if request.param == "obj_mesh":
        return _mesh_scene(tmp_path)
    return str(SCENES_DIR / f"{request.param}.xml")


def _bits(a):
    """Arrays compared bit for bit (bvh_nodes holds bitcast ints, some of
    them NaN patterns as float32)."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_host_layer_matches_jax(scene_path):
    ref, ref_parsed = jax_load_scene(scene_path)
    got, parsed = load_scene(scene_path)
    for f in dataclasses.fields(ScenePack):
        r, g = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(g, np.ndarray):
            assert g.dtype == np.asarray(r).dtype, f.name
            np.testing.assert_array_equal(_bits(g), _bits(r), err_msg=f.name)
        else:
            assert g == r, f.name
    assert parsed.camera.width == ref_parsed.camera.width
    assert parsed.camera.vfov == ref_parsed.camera.vfov
    assert parsed.samples_per_pixel == ref_parsed.samples_per_pixel


def _assert_scene_equal(got: DeviceScene, ref: JaxDeviceScene):
    for f in dataclasses.fields(DeviceScene):
        r, g = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(g, torch.Tensor):
            r = np.asarray(r)
            assert g.dtype == torch.from_numpy(np.array(r)).dtype, f.name
            assert tuple(g.shape) == r.shape, f.name
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(r),
                                          err_msg=f.name)
        else:
            assert g == r, f.name


def test_device_scene_from_pack_and_from_numpy(scene_path):
    ref = JaxDeviceScene.from_pack(jax_load_scene(scene_path)[0])
    _assert_scene_equal(DeviceScene.from_pack(load_scene(scene_path)[0]),
                        ref)
    fields = {f.name: (getattr(ref, f.name)
                       if isinstance(getattr(ref, f.name), int)
                       else np.asarray(getattr(ref, f.name)))
              for f in dataclasses.fields(JaxDeviceScene)}
    from_numpy = DeviceScene.from_numpy(fields)
    _assert_scene_equal(from_numpy, ref)
    # and both render the same image
    pack, parsed = load_scene(scene_path)
    cd = torch.from_numpy(camera_ray_data(Camera.from_parsed(parsed.camera),
                                          16, 12))
    a = integrator.render_samples(from_numpy, cd, 16, 12, 0, 2, max_depth=3,
                                  nee=True)
    b = integrator.render_samples(DeviceScene.from_pack(pack), cd, 16, 12, 0,
                                  2, max_depth=3, nee=True)
    assert torch.equal(a, b) and float(a.sum()) > 0


def test_device_scene_to_moves_every_tensor():
    scene = DeviceScene.from_pack(
        load_scene(str(SCENES_DIR / "cbox_rect.xml"))[0])
    moved = scene.to("meta")
    for f in dataclasses.fields(DeviceScene):
        value = getattr(moved, f.name)
        if isinstance(value, torch.Tensor):
            assert value.device.type == "meta", f.name
        else:
            assert value == getattr(scene, f.name)
    assert scene.prim_rows.device.type == "cpu"
    assert moved.num_prims == 32


def test_cbox_rect_is_a_closed_cornell_box():
    pack, parsed = load_scene(str(SCENES_DIR / "cbox_rect.xml"))
    assert (parsed.camera.width, parsed.camera.height) == (640, 480)
    assert pack.num_spheres == 0 and 30 <= pack.num_triangles <= 40
    lo, hi = pack.vert_pos.min(0), pack.vert_pos.max(0)
    cam = np.asarray(parsed.camera.lookfrom)
    assert (cam > lo).all() and (cam < hi).all()      # camera inside
    # the light's shading normals face down into the box, so front_emit
    # (cos_view > 0) lights the room
    emit = np.abs(pack.prim_emission).sum(1) > 0
    assert emit.sum() == 2
    normals = pack.vert_nrm[pack.tri_vidx[emit[pack.num_spheres:]]]
    np.testing.assert_allclose(normals.reshape(-1, 3),
                               np.tile([0.0, -1.0, 0.0], (6, 1)), atol=1e-6)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    root = Path(port.__file__).resolve().parent
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib"), f"{path} imports {name}"
            assert top != "pathtracer_cuda_interactive_tpu", \
                f"{path} imports the JAX package ({name})"
