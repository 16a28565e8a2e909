"""heif_tpu_torch stands alone: it imports nothing of heif_tpu and never
reaches JAX.

- Static: no .py under heif_tpu_torch/, and not chip_smoke.py, has an
  `import heif_tpu...` or `from heif_tpu... import` of the JAX package
  (heif_tpu_torch itself is fine).
- In a fresh interpreter whose sys.meta_path refuses `jax`, `heif_tpu`
  and `heif_tpu.*`: every module of the port imports, then chip_smoke
  (import only: its main runs under __name__ == "__main__"), then
  flagship tile 1 decodes on device="cpu" (the port's own container,
  header, native entropy and reconstruction layers), and `jax` is still
  not in sys.modules.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
IMPORT = re.compile(r"^\s*(from|import)\s+heif_tpu(\.|\s|$)", re.M)


def test_no_heif_tpu_import_in_the_port():
    files = sorted((ROOT / "heif_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    bad = [f"{f.relative_to(ROOT)}:{m.group(0).strip()}"
           for f in files for m in IMPORT.finditer(f.read_text())]
    assert not bad, bad


def test_port_runs_with_jax_and_heif_tpu_blocked():
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "heif_tpu"):
                    raise ImportError(f"{name} is refused")
                return None

        for name in [m for m in sys.modules
                     if m.split(".")[0] in ("jax", "heif_tpu")]:
            del sys.modules[name]
        sys.meta_path.insert(0, Refuse())
        import heif_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            heif_tpu_torch.__path__, "heif_tpu_torch.")
            if not m.name.endswith("__main__")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert callable(chip_smoke.main)

        from heif_tpu_torch import HeicDecoder
        from heif_tpu_torch.utils.annexb import tile_annexb
        data = open("tests/assets/halfmoonbay.heic", "rb").read()
        out = HeicDecoder.decode_hevc(tile_annexb(data, 1), device="cpu")
        assert out["Y"].shape == (512, 512) and out["Cb"].shape == (256, 256)
        assert "jax" not in sys.modules
        assert not [m for m in sys.modules if m.split(".")[0] == "heif_tpu"]
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 40
