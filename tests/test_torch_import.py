"""The PyTorch port stands alone: after importing every module of
``reazonspeech_tpu_torch``, and after running its checkpoint converters on
published-layout fixtures, neither JAX nor any module of the JAX package
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
# the beam decoders' step kernels
DECODE_STEP_MODULES = ["reazonspeech_tpu_torch." + m
                       for m in ("ops.lstm_step", "ops.beam_topk", "decoding.rnnt_beam")]
# the serving stack
SERVING_MODULES = ["reazonspeech_tpu_torch.serving." + m
                   for m in ("batcher", "continuous", "http")] + ["reazonspeech_tpu_torch.serving"]
# the decode options, the host-side modules and the v1 and 1seg pipelines
PIPELINE_MODULES = ["reazonspeech_tpu_torch." + m for m in (
    "decoding.transducer_maes", "core.text", "core.fs", "espnet.oneseg", "oneseg",
    "oneseg.interface", "oneseg.text", "oneseg.encoding", "oneseg.caption",
    "oneseg.sentence", "oneseg.utils", "oneseg.align", "v1", "v1.interface",
    "v1.transcribe", "v1.cli")]
# the checkpoint converters
CONVERT_MODULES = ["reazonspeech_tpu_torch.convert." + m
                   for m in ("torch_utils", "quantize", "onnx_reader", "nemo_fastconformer",
                             "espnet_conformer", "icefall_zipformer", "onnx_zipformer")]
# the AVSR family, its converter and its executor
AVSR_MODULES = ["reazonspeech_tpu_torch.avsr"] + [
    "reazonspeech_tpu_torch.avsr." + m
    for m in ("configuration_avhubert", "resnet3d", "model", "feature_extraction",
              "processing")] + ["reazonspeech_tpu_torch.convert.hf_avhubert",
                                "reazonspeech_tpu_torch.serving.avsr"]
# training: the losses, the train step, the Trainer, manifest batches, and
# the kernel-forward autograd wrappers' shared Function
TRAINING_MODULES = ["reazonspeech_tpu_torch.training"] + [
    "reazonspeech_tpu_torch.training." + m
    for m in ("losses", "pruned_rnnt", "train_step", "data", "trainer")] + [
    "reazonspeech_tpu_torch.ops._vjp"]
# streaming, and the host-side modules: native/, evaluation, on-device
# resampling, profiling and the compile cache
HOST_MODULES = ["reazonspeech_tpu_torch." + m for m in (
    "models.fastconformer_streaming", "native", "evaluation", "evaluation.base",
    "evaluation.utils", "evaluation.mesh", "frontend.resample", "utils", "utils.profiling",
    "utils.compile_cache")]
# parallelism over a single-process mesh
PARALLEL_MODULES = ["reazonspeech_tpu_torch.parallel"] + [
    "reazonspeech_tpu_torch.parallel." + m
    for m in ("mesh", "serving", "pipeline", "sequence", "tensor")]

# each converter run on a published-layout fixture (its lazy imports
# included: torch, yaml, the port's models), then the modules loaded
_CONVERT_ALL = """
import os, sys, tempfile
sys.path.insert(0, "tests")
import fixture_checkpoints as fx
from reazonspeech_tpu_torch.convert import (
    espnet_conformer, nemo_fastconformer, onnx_zipformer, quantize)
from reazonspeech_tpu_torch.k2.asr.huggingface import hf_repo_files
from reazonspeech_tpu_torch.models import conformer, fastconformer, rnnt, zipformer
d = tempfile.mkdtemp()
enc = fastconformer.FastConformerConfig.tiny()
fx.write_nemo_archive(d + "/m.nemo", enc, rnnt.RNNTConfig.tiny(enc_dim=enc.d_model))
nemo_fastconformer.convert_nemo_checkpoint(d + "/m.nemo", d + "/nemo")
tokens = ["<blank>", "a", "b", "<sos/eos>"]
enc = conformer.espnet_encoder_config(num_layers=1, d_model=32, num_heads=4,
                                      subsampling_channels=32)
fx.write_espnet_zoo(d + "/zoo", enc, tokens)
run = d + "/zoo/exp/asr_train_asr_conformer_raw_jp_char/"
espnet_conformer.convert_espnet_checkpoint(run + "valid.acc.ave_10best.pth", d + "/espnet",
                                           config_yaml=run + "config.yaml")
enc = zipformer.ZipformerConfig.tiny()
fx.write_k2_repo(d + "/k2", enc, rnnt.RNNTConfig(vocab_size=4, enc_dim=enc.out_dim,
                 pred_hidden=16, joint_hidden=24, predictor_kind="stateless"), tokens,
                 int8=True)
f = {k: d + "/k2/" + v for k, v in hf_repo_files("int8", 99).items()}
params, _, _ = onnx_zipformer.convert_sherpa_snapshot(
    f["encoder"], f["decoder"], f["joiner"], d + "/k2tree", tokens_txt=f["tokens"],
    icefall_pt=d + "/k2/exp/pretrained.pt", enc_cfg=enc)
quantize.dequantize_tree(quantize.quantize_tree(params))
print(",".join(sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
                      or m == "reazonspeech_tpu" or m.startswith("reazonspeech_tpu."))))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, names = out.stdout.splitlines()[:2]
    n_modules, leaked = first.split()[0], first.strip().partition(" ")[2]
    assert int(n_modules) >= 20
    assert leaked == "", f"imported by the port: {leaked}"
    missing = sorted(set(ESPNET_MODULES + DECODE_STEP_MODULES + CONVERT_MODULES
                         + SERVING_MODULES + PIPELINE_MODULES + AVSR_MODULES
                         + TRAINING_MODULES + HOST_MODULES + PARALLEL_MODULES)
                     - set(names.split()))
    assert not missing, f"not imported: {missing}"


def test_converters_run_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CONVERT_ALL], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    leaked = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    assert leaked == "", f"loaded by the converters: {leaked}"


# the server's entry point, run as its module: the flags parse and the
# serving stack loads with neither JAX nor the JAX package
_SERVE_HELP = """
import runpy, sys
sys.argv = ["http", "--help"]
try:
    runpy.run_module("reazonspeech_tpu_torch.serving.http", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
print("loaded:" + ",".join(sorted(
    m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
    or m == "reazonspeech_tpu" or m.startswith("reazonspeech_tpu."))))
"""


def test_server_entry_point_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _SERVE_HELP], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--continuous" in out.stdout and "--max-pending" in out.stdout
    leaked = out.stdout.strip().splitlines()[-1]
    assert leaked == "loaded:", f"loaded by the server: {leaked}"


# the v1 CLI, run as its module: its help prints with neither JAX nor the
# JAX package loaded, and its data files (the symbol and gaiji tables) are
# the port's own
_V1_HELP = """
import runpy, sys
sys.argv = ["v1", "--help"]
try:
    runpy.run_module("reazonspeech_tpu_torch.v1.cli", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
from reazonspeech_tpu_torch.core.text import cer, normalize
from reazonspeech_tpu_torch.oneseg.encoding import _GAIJI_TABLE
assert normalize("abc") == "ａｂｃ" and len(_GAIJI_TABLE) == 449, len(_GAIJI_TABLE)
print("loaded:" + ",".join(sorted(
    m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
    or m == "reazonspeech_tpu" or m.startswith("reazonspeech_tpu."))))
"""


def test_v1_cli_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _V1_HELP], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "python -m reazonspeech_tpu_torch.v1.cli" in out.stdout
    leaked = out.stdout.strip().splitlines()[-1]
    assert leaked == "loaded:", f"loaded by the v1 CLI: {leaked}"


# chip_smoke.py imported, its AVSR phase's imports made and the AVSR
# converter run on a published-layout fixture: nothing of JAX or the JAX
# package is loaded, and no import statement of the script names them
_SMOKE = """
import ast, sys, tempfile
sys.path.insert(0, "tests")
import chip_smoke
import fixture_checkpoints as fx
from reazonspeech_tpu_torch.avsr import AVHubertConfig, AVHubertForConditionalGeneration
from reazonspeech_tpu_torch.avsr import model, resnet3d
from reazonspeech_tpu_torch.serving import http
d = tempfile.mkdtemp()
fx.write_avhubert_hf_dir(d, AVHubertConfig.tiny(audio_feat_dim=104))
AVHubertForConditionalGeneration.from_pretrained(d, device="cpu")
names = []
for node in ast.walk(ast.parse(open("chip_smoke.py").read())):
    if isinstance(node, ast.Import):
        names += [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        names.append(node.module)
bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "reazonspeech_tpu")]
print("named:" + ",".join(bad))
print("loaded:" + ",".join(sorted(
    m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
    or m == "reazonspeech_tpu" or m.startswith("reazonspeech_tpu."))))
"""


def test_chip_smoke_and_avsr_load_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _SMOKE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    named, loaded = out.stdout.strip().splitlines()[-2:]
    assert named == "named:", f"chip_smoke.py imports {named}"
    assert loaded == "loaded:", f"loaded by chip_smoke.py and the AVSR path: {loaded}"
