"""The program's side of a configuration: its scene and camera, built
through the program's own entry points from the configuration's
``program`` entry.

* ``{"sample": name}`` — ``fspt_tpu_torch.scene.samples.build(name)`` with
  its standard camera;
* ``{"scene_file": path}`` — the program's ``.scene`` parser, the file's
  first camera; with ``textured_cornell`` the file is first copied with
  textures by ``samples.write_textured_cornell`` to ``write_to``, a fixed
  path inside the checkout.
"""

from __future__ import annotations

from pathlib import Path


def program_scene(root: Path, config: dict, device):
    from fspt_tpu_torch.scene import parser, samples

    prog = config["program"]
    if "sample" in prog:
        b = samples.build(prog["sample"], device=device)
    else:
        path = root / prog["scene_file"]
        tex = prog.get("textured_cornell")
        if tex is not None:
            out = root / tex["write_to"]
            out.parent.mkdir(parents=True, exist_ok=True)
            path = samples.write_textured_cornell(path, out, root / tex["wall_texture"],
                                                  root / tex["sky_texture"],
                                                  wall_scale=tex["wall_scale"])
        b = parser.load_scene(str(path), device=device)
    return b.compile(device=device), b.cameras[0]
