"""Scene pretty-printer — parity with the reference's print_scene.cpp
(C12 in SURVEY.md): human-readable dump of every Parsed* IR entity, plus a
CLI so it is actually reachable (the reference compiles its printer but
never calls it, Makefile:25 / SURVEY.md C12).  The port of
``pathtracer_cuda_interactive_tpu/io/print_scene.py``: numpy and the
port's models/ir.py only, the same output string for string.

Usage:  python -m pathtracer_cuda_interactive_tpu_torch.io.print_scene scene.xml
"""

from __future__ import annotations

import numpy as np

from ..models import ir


def _v(x) -> str:
    a = np.asarray(x).reshape(-1)
    return "(" + ", ".join(f"{float(c):g}" for c in a) + ")"


def _color(c) -> str:
    if isinstance(c, ir.ImageTexture):
        return (f"ImageTexture[filename={c.filename}, uscale={c.uscale:g}, "
                f"vscale={c.vscale:g}, uoffset={c.uoffset:g}, "
                f"voffset={c.voffset:g}]")
    return _v(c)


def format_camera(cam: ir.ParsedCamera) -> str:
    return (f"Camera[lookfrom={_v(cam.lookfrom)}, lookat={_v(cam.lookat)}, "
            f"up={_v(cam.up)}, vfov={cam.vfov:g}, "
            f"width={cam.width}, height={cam.height}]")


def format_material(m) -> str:
    if isinstance(m, ir.ParsedDiffuse):
        return f"Diffuse[reflectance={_color(m.reflectance)}]"
    if isinstance(m, ir.ParsedMirror):
        return f"Mirror[reflectance={_color(m.reflectance)}]"
    if isinstance(m, ir.ParsedPlastic):
        return (f"Plastic[eta={m.eta:g}, "
                f"reflectance={_color(m.reflectance)}]")
    if isinstance(m, ir.ParsedPhong):
        return (f"Phong[reflectance={_color(m.reflectance)}, "
                f"exponent={m.exponent:g}]")
    if isinstance(m, ir.ParsedBlinnPhong):
        return (f"BlinnPhong[reflectance={_color(m.reflectance)}, "
                f"exponent={m.exponent:g}]")
    if isinstance(m, ir.ParsedBlinnPhongMicrofacet):
        return (f"BlinnPhongMicrofacet[reflectance={_color(m.reflectance)}, "
                f"exponent={m.exponent:g}]")
    return repr(m)


def format_light(l) -> str:
    if isinstance(l, ir.ParsedPointLight):
        return (f"PointLight[position={_v(l.position)}, "
                f"intensity={_v(l.intensity)}]")
    if isinstance(l, ir.ParsedDiffuseAreaLight):
        return (f"DiffuseAreaLight[shape_id={l.shape_id}, "
                f"radiance={_v(l.radiance)}]")
    return repr(l)


def format_shape(s) -> str:
    if isinstance(s, ir.ParsedSphere):
        return (f"Sphere[material_id={s.material_id}, "
                f"area_light_id={s.area_light_id}, center={_v(s.center)}, "
                f"radius={s.radius:g}]")
    if isinstance(s, ir.ParsedTriangleMesh):
        return (f"TriangleMesh[material_id={s.material_id}, "
                f"area_light_id={s.area_light_id}, "
                f"vertices={int(s.positions.shape[0])}, "
                f"triangles={int(s.indices.shape[0])}, "
                f"normals={'yes' if s.normals is not None else 'no'}, "
                f"uvs={'yes' if s.uvs is not None else 'no'}]")
    return repr(s)


def format_scene(scene: ir.ParsedScene) -> str:
    out = ["Scene["]
    out.append(f"  {format_camera(scene.camera)}")
    out.append(f"  background_color={_v(scene.background_color)}")
    out.append(f"  samples_per_pixel={scene.samples_per_pixel}")
    out.append(f"  materials[{len(scene.materials)}]:")
    out.extend(f"    [{i}] {format_material(m)}"
               for i, m in enumerate(scene.materials))
    out.append(f"  lights[{len(scene.lights)}]:")
    out.extend(f"    [{i}] {format_light(l)}"
               for i, l in enumerate(scene.lights))
    out.append(f"  shapes[{len(scene.shapes)}]:")
    out.extend(f"    [{i}] {format_shape(s)}"
               for i, s in enumerate(scene.shapes))
    out.append("]")
    return "\n".join(out)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="torrey-torch-print-scene")
    ap.add_argument("scene", help="Mitsuba-0.6 scene XML")
    args = ap.parse_args(argv)

    from .xml_scene import parse_scene
    print(format_scene(parse_scene(args.scene)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
