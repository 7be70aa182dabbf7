"""Base evaluator for speech-recognition evaluation over HF datasets.

A copy of ``reazonspeech_tpu/evaluation/base.py`` (jax-free; the port keeps
its own). Contract parity with the reference (pkg/evaluation/src/base.py:
1-303): the same constructor/evaluate() signatures, polymorphic dataset
loading, map()-based process parallelism with spawn for multi-accelerator
runs, CER aggregation printed as ``CER: x.xx%``, and optional JSONL dump.
``datasets`` and ``multiprocess`` are imported when a dataset is loaded or a
multi-accelerator map starts, never when this module is, so the package
imports without them.

The implementation is restructured around small helpers: loading is a chain
of ``_coerce_*`` converters, prediction/scoring are separate passes, and the
spawn/forkserver start-method flip around multi-accelerator maps lives in a
context manager.
"""

import contextlib
import os
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Callable, Optional, TypedDict

from .utils import CERResult, calculate_cer

__all__ = ["BaseEvaluator", "EvaluationResult", "EvaluationResultBatch"]


class EvaluationResult(TypedDict):
    """Result of evaluating a single example."""

    prediction: str


class EvaluationResultBatch(TypedDict):
    """Result of evaluating a batch of examples."""

    predictions: list[str]


@contextlib.contextmanager
def _spawned_workers(enabled: bool):
    """Force 'spawn' workers for the enclosed dataset.map (accelerator
    handles don't survive fork), restoring 'forkserver' afterwards — the
    reference's start-method dance around its multi-GPU map."""
    if not enabled:
        yield
        return
    from multiprocess import set_start_method

    set_start_method("spawn", force=True)
    try:
        yield
    finally:
        set_start_method("forkserver", force=True)


def _dataset_from_path(path, num_proc):
    """A file loads via its extension's HF builder (jsonl -> json); a
    directory loads as a dataset script/tree, train split."""
    from datasets import load_dataset

    path = Path(path)
    if path.is_file():
        builder = path.suffix.removeprefix(".")
        if builder == "jsonl":
            builder = "json"
        files = {"train": path.as_posix()}
        return load_dataset(builder, data_files=files, num_proc=num_proc)["train"]
    if path.is_dir():
        return load_dataset(
            path.as_posix(), split="train", trust_remote_code=True,
            num_proc=num_proc,
        )
    raise ValueError(f"Invalid dataset path: {path}")


class BaseEvaluator(ABC):
    """Abstract base class for speech recognition evaluators.

    Subclasses implement ``_evaluate`` (one example) and ``_evaluate_batch``
    (a batch); ``evaluate()`` drives them over a dataset with optional process
    parallelism and reports aggregate CER.
    """

    def __init__(
        self,
        model=None,
        processor=None,
        dataset=None,
        output_file: Optional[os.PathLike] = None,
        batch_size: Optional[int] = None,
        num_proc: Optional[int] = None,
        num_gpus: Optional[int] = None,
        text_column: str = "text",
    ):
        self.model = model
        self.processor = processor
        self.output_file = output_file
        self.batch_size = batch_size
        self.num_proc = num_proc
        self.num_gpus = num_gpus
        self.text_column = text_column
        self.dataset = None if dataset is None else self._load_dataset(dataset)

    # -- dataset coercion ---------------------------------------------------

    def _load_dataset(self, dataset):
        """Coerce a Dataset / dict / generator callable / path into a
        Dataset (same polymorphism as the reference loader)."""
        from datasets import Dataset

        converters = (
            (Dataset, lambda d: d),
            (dict, Dataset.from_dict),
            (Callable, Dataset.from_generator),
            (
                (os.PathLike, str),
                lambda d: _dataset_from_path(d, self.num_proc),
            ),
        )
        for kinds, convert in converters:
            if isinstance(dataset, kinds):
                return convert(dataset)
        raise ValueError(f"Invalid dataset type: {type(dataset)}")

    # -- scoring ------------------------------------------------------------

    def _calculate_cer(self, example: dict[str, Any], text_column: str) -> CERResult:
        return calculate_cer(example[text_column], example["prediction"])

    def _score(self, dataset, text_column, num_proc):
        """Attach distance/length columns; return (dataset, cer_fraction)."""
        scored = dataset.map(
            self._calculate_cer,
            num_proc=num_proc,
            fn_kwargs={"text_column": text_column},
        )
        cer = sum(scored["distance"]) / sum(scored["length"])
        return scored, cer

    # -- prediction ---------------------------------------------------------

    def _predict(self, dataset, batch_size, num_proc, num_gpus, with_rank):
        """Map the subclass model hook over the dataset, producing the
        'prediction' column. ``batch_size=None`` runs row-wise."""
        hook_kwargs = {"num_gpus": num_gpus, "num_proc": num_proc}
        if batch_size is None:
            return dataset.map(
                self._evaluate,
                with_rank=with_rank,
                num_proc=num_proc,
                fn_kwargs=hook_kwargs,
            )

        # note: the reference forgets batched=True on this branch (its batch
        # path feeds single rows to _evaluate_batch); fixed here, with the
        # 'predictions' list mapped onto the per-row 'prediction' column.
        def rows_from_batch(batch, *args, **kwargs):
            return {"prediction": self._evaluate_batch(batch, *args, **kwargs)["predictions"]}

        return dataset.map(
            rows_from_batch,
            batched=True,
            batch_size=batch_size,
            with_rank=with_rank,
            num_proc=num_proc,
            fn_kwargs=hook_kwargs,
        )

    # -- public API ---------------------------------------------------------

    def evaluate(
        self,
        dataset=None,
        batch_size: Optional[int] = None,
        num_proc: Optional[int] = None,
        num_gpus: Optional[int] = None,
        text_column: Optional[str] = None,
        output_file: Optional[os.PathLike] = None,
    ):
        """Run the model over the dataset, add prediction/distance/length
        columns, print aggregate CER, optionally dump JSONL.

        Returns the evaluated Dataset.
        """
        if dataset is None:
            dataset = self.dataset
        else:
            dataset = self._load_dataset(dataset)
        if dataset is None:
            raise ValueError("No dataset provided and self.dataset is None.")

        batch_size = batch_size or self.batch_size
        num_proc = num_proc or self.num_proc
        num_gpus = num_gpus or self.num_gpus
        text_column = text_column or self.text_column
        output_file = output_file or self.output_file

        multi_accel = bool(num_gpus and num_proc and num_gpus > 1)
        with _spawned_workers(multi_accel):
            predicted = self._predict(
                dataset, batch_size, num_proc, num_gpus, with_rank=multi_accel
            )

        evaluated, cer = self._score(predicted, text_column, num_proc)
        print(f"CER: {cer * 100:.2f}%")

        if output_file is not None:
            evaluated.to_json(output_file, num_proc=num_proc, force_ascii=False)
        return evaluated

    def calculate_cer(self, dataset, text_column=None, num_proc=None) -> float:
        """Aggregate CER over a dataset that already has predictions."""
        _, cer = self._score(
            dataset, text_column or self.text_column, num_proc or self.num_proc
        )
        return cer

    @abstractmethod
    def _evaluate(self, example: dict[str, Any], *args, **kwargs) -> EvaluationResult:
        """Evaluate a single example; return {'prediction': text}."""
        raise NotImplementedError("Subclasses must implement _evaluate method")

    @abstractmethod
    def _evaluate_batch(
        self, batch: dict[str, Any], *args, **kwargs
    ) -> EvaluationResultBatch:
        """Evaluate a batch; return {'predictions': [text, ...]}."""
        raise NotImplementedError("Subclasses must implement _evaluate_batch method")
