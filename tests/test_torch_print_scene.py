"""The port's scene printer (io/print_scene.py) against the JAX package's:
the same text, string for string, on every in-repo scene, and the CLI."""

import pytest

from pathtracer_cuda_interactive_tpu.io.print_scene import (
    format_scene as jax_format_scene)
from pathtracer_cuda_interactive_tpu.io.xml_scene import (
    parse_scene as jax_parse_scene)
from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.io import print_scene
from pathtracer_cuda_interactive_tpu_torch.io.xml_scene import parse_scene

SCENES = ("cbox_rect", "spheres", "pointlight", "blob_box")


@pytest.mark.parametrize("name", SCENES)
def test_format_scene_equals_jax(name):
    path = str(SCENES_DIR / f"{name}.xml")
    got = print_scene.format_scene(parse_scene(path))
    assert got == jax_format_scene(jax_parse_scene(path))
    assert got.startswith("Scene[\n  Camera[lookfrom=")


def test_format_shows_each_kind():
    txt = print_scene.format_scene(parse_scene(str(SCENES_DIR
                                                   / "blob_box.xml")))
    assert "TriangleMesh[" in txt and "Sphere[" in txt
    assert "PointLight[" in txt and "DiffuseAreaLight[" in txt
    assert "Mirror[" in txt and "Diffuse[" in txt


def test_cli(capsys):
    assert print_scene.main([str(SCENES_DIR / "cbox_rect.xml")]) == 0
    out = capsys.readouterr().out
    assert out.startswith("Scene[") and "TriangleMesh[" in out
