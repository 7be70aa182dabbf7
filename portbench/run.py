"""The benchmark of ``reazonspeech_tpu_torch`` (the PyTorch and CUDA port).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the machine it is started on and
prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` (and
with ``--trace 1`` ``breakdown``), and last ``checks``, each number compared
with its limit; the same numbers end standard error.

Everything is found by name: the cell's configuration in
``configs/<config>.json`` (its ``family`` names ``families/<family>.py``),
its traffic in ``traffic/<traffic>.json`` (its ``kind`` names
``runners/<kind>.py``), its limits in ``checks/<cell>.json``, and each
per-layer metric's reader in ``metrics/<metric>.py``.

It exits non-zero and prints no result without enough CUDA devices, where
the port is not the checkout's own, or where ``jax``, ``jaxlib``, ``flax``,
``reazonspeech_tpu`` or ``reazonspeech`` is imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "reazonspeech_tpu", "reazonspeech")
PROGRAM = "reazonspeech_tpu_torch"


class Refused(Exception):
    """The run cannot give a result here (exit code 2, no result line)."""


def forbidden_modules():
    """Top-level names in ``sys.modules`` that this process must not load,
    compared whole (``reazonspeech_tpu_torch`` is not ``reazonspeech_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _environment():
    """Caches at fixed paths inside the checkout, and no JAX or TensorFlow
    pulled in by a library the port uses."""
    cache = ROOT / "build" / "portbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ["USE_JAX"] = "0"


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise Refused(f"{path} is not there")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    if not path.is_file():
        raise Refused(f"{path} is not there")
    return json.loads(path.read_text())


class Run:
    """One run of one cell: what it was given, what it measured."""

    def __init__(self, args, manifest, device, overrides=None):
        overrides = overrides or {}
        cells = {w["name"]: w for w in manifest["workloads"]}
        if args.workload not in cells:
            raise Refused(f"no workload {args.workload!r} in BENCHMARK.json")
        self.cell = cells[args.workload]
        self.manifest = manifest
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.device = device
        self.cfg = {**_json(BENCH / "configs" / f"{self.cell['config']}.json"),
                    **overrides.get("config", {})}
        self.mix = {**_json(BENCH / "traffic" / f"{self.cell['traffic']}.json"),
                    **overrides.get("traffic", {})}
        self.limits = {**_json(BENCH / "checks" / f"{self.cell['name']}.json")["limits"],
                       **overrides.get("limits", {})}
        self.family = importlib.import_module(f"portbench.families.{self.cfg['family']}")
        self.runner = importlib.import_module(f"portbench.runners.{self.mix['kind']}")
        self.e2e = [m for m in manifest["end_to_end"] if self._here(m)]
        self.per_layer = [m for m in manifest["per_layer"] if self._here(m)]
        self.readers = {m["name"]: _load(BENCH / "metrics" / f"{m['name']}.py",
                                         f"portbench_metric_{i}")
                        for i, m in enumerate(self.per_layer)} if self.trace else {}
        self.range_targets = {}
        for reader in self.readers.values():
            self.range_targets.update(getattr(reader, "RANGES", {}))
        self.rec = {"notes": []}
        self.setup_s = None

    def _here(self, metric):
        """Whether this cell reports ``metric``: named in its ``workloads``,
        or, without that key, this cell reports the end-to-end metric the
        per-layer one moves (an end-to-end one without it: every cell)."""
        if "workloads" in metric:
            return self.cell["name"] in metric["workloads"]
        moved = metric.get("moves")
        if moved is None:
            return True
        return any(m["name"] == moved and self._here(m) for m in self.manifest["end_to_end"])

    def setup_done(self):
        """The window starts: set-up ends here, and the memory peak restarts."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.setup_s = time.perf_counter() - T_START

    def record(self, note=None, **values):
        if note:
            self.rec["notes"].append(note)
        self.rec.update(values)


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _log(msg):
    print(f"[portbench {time.perf_counter() - T_START:8.2f}s] {msg}", file=sys.stderr,
          flush=True)


def _device(chips):
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}")
    return torch.device("cuda", 0)


def _program():
    """The port, imported from this checkout and nowhere else."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    try:
        pkg = importlib.import_module(PROGRAM)
    except ImportError as e:
        raise Refused(f"the program {PROGRAM} cannot be imported: {e}") from e
    where = Path(pkg.__file__).resolve()
    if ROOT not in where.parents:
        raise Refused(f"{PROGRAM} comes from {where}, not from this checkout {ROOT}")
    return pkg


def execute(argv=None, device=None, overrides=None, fault=None):
    """One run; returns the result object. ``device``, ``overrides`` (of the
    configuration, traffic and limits) and ``fault`` (applied to the
    program's model after it is built) are for the tests, which drive a run
    at a tiny size on the CPU."""
    args = _parse(argv)
    _environment()
    manifest = _json(ROOT / "BENCHMARK.json")
    _program()
    import torch

    from .weights import make_tree

    cell = next((w for w in manifest["workloads"] if w["name"] == args.workload), {})
    device = device or _device(cell.get("chips", 1))
    run = Run(args, manifest, device, overrides)
    _log(f"cell {run.cell['name']}: {run.cell['config']} x {run.cell['traffic']}, seed "
         f"{args.seed}, {args.seconds} s, trace {args.trace}, on {device}")
    params = make_tree(run.family.spec(run.cfg), args.seed, device)
    batches = run.runner.stage(run.mix, args.seed, device)
    run.sample = pick(args.seed, batches, run.mix["sample"])
    model = run.family.build(run.cfg, params, device, args.seed)
    if fault is not None:
        fault(model)
    _log("weights, model and traffic made; warming up")
    calls = run.runner.window(run, model, batches)
    for note in run.rec["notes"]:
        _log(note)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del model
    if cuda:
        torch.cuda.empty_cache()
    numbers = verify(run, params, batches, calls)
    from .check import judge

    correct, rows = judge(numbers, run.limits)
    metrics = {}
    if run.trace:
        for m in run.per_layer:
            value = run.readers[m["name"]].read(run.rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**run.rec.get("e2e", {}), "setup_s": run.setup_s}
        for m in run.e2e:
            if m["name"] not in values:
                raise RuntimeError(f"the {run.mix['kind']} runner gives no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": run.cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.rec["attempted"],
              "failed": run.rec["failed"], "metrics": metrics, "device": dev}
    if run.trace:
        dev["busy_s"], dev["window_s"] = run.rec["busy_s"], run.rec["window_s"]
        result["breakdown"] = run.rec["breakdown"]
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    found = forbidden_modules()
    if found:
        raise Refused(f"modules that must not be loaded are: {found}")
    for name, v, lim in rows:
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    return result


def pick(seed, batches, k):
    """(batch, row) of ``k`` utterances of the distinct ``batches`` that the
    seed draws, the longest always among them, in order."""
    import numpy as np

    flat = [(b, i) for b in range(len(batches)) for i in range(len(batches[b]))]
    longest = max(range(len(flat)), key=lambda j: len(batches[flat[j][0]][flat[j][1]]))
    rng = np.random.default_rng([seed, 7])
    rest = [j for j in rng.permutation(len(flat)) if j != longest][:min(k, len(flat)) - 1]
    return sorted(flat[j] for j in [longest] + rest)


def verify(run, params, batches, calls):
    """The numbers compared, over every call of the window: each call's
    encoder rows and served hypotheses of the sampled utterances of its
    batch (``run.sample``), against the reference of those utterances
    (each distinct served hypothesis once)."""
    from .check import enc_rel_l2, reference_encode, token_gap
    from .reference.numerics import Numerics

    t0 = time.perf_counter()
    encoded = dict(zip(run.sample, reference_encode(
        run.family, run.cfg, params, [batches[b][i] for b, i in run.sample], run.device,
        Numerics("fp32"))))
    refs, captured, hyps = [], [], {}
    for b, served, enc, lens in calls:
        rows = [i for d, i in run.sample if d == b]
        for j, i in enumerate(rows):
            refs.append(encoded[(b, i)])
            captured.append((enc[j], lens[j]))
            hyps.setdefault((b, i, tuple(served[i][0]), tuple(served[i][1])), served[i])
    numbers = {"enc_rel_l2": enc_rel_l2(run.cfg, params, refs, captured) if refs else None,
               "token_gap": token_gap(run.cfg, params, [encoded[h[:2]] for h in hyps],
                                      list(hyps.values())) if hyps else None}
    _log(f"reference over {len(run.sample)} utterances, {len(refs)} encoder rows of "
         f"{len(calls)} calls, {len(hyps)} distinct served hypotheses "
         f"({sum(len(h[0]) for h in hyps.values())} labels): {time.perf_counter() - t0:.2f} s")
    return numbers


def main(argv=None):
    try:
        result = execute(argv)
    except Refused as e:
        _log(f"no result: {e}")
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import portbench.run as _run  # the package's module, not __main__

    _run.T_START = T_START
    sys.exit(_run.main())
