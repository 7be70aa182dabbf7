"""The PyTorch port stands alone: after importing every module of
``reazonspeech_tpu_torch``, neither JAX nor any module of the JAX package
(``reazonspeech_tpu`` itself or ``reazonspeech_tpu.*``, ``core`` included:
the port keeps its own copy) is in ``sys.modules``."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import reazonspeech_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
jax_pkg = sorted(m for m in sys.modules
                 if m == "reazonspeech_tpu" or m.startswith("reazonspeech_tpu."))
print(len(names), ",".join(leaked + jax_pkg))
print(" ".join(names))
"""

# the modules of the espnet slice, among those the walk must import
ESPNET_MODULES = [
    "reazonspeech_tpu_torch.espnet.asr." + m
    for m in ("model", "ctc", "transcribe", "interface", "cli")
] + ["reazonspeech_tpu_torch.decoding.ctc", "reazonspeech_tpu_torch.decoding.transducer_graves",
     "reazonspeech_tpu_torch.models.conformer"]


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, names = out.stdout.splitlines()[:2]
    n_modules, leaked = first.split()[0], first.strip().partition(" ")[2]
    assert int(n_modules) >= 20
    assert leaked == "", f"imported by the port: {leaked}"
    missing = sorted(set(ESPNET_MODULES) - set(names.split()))
    assert not missing, f"not imported: {missing}"
