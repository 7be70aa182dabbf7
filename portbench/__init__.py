"""The benchmark of the PyTorch and CUDA port (``reazonspeech_tpu_torch``).
Run ``python3 portbench/run.py --help``; see ``run.py``."""
