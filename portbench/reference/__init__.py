"""The benchmark's plain reference: fp32 PyTorch (TF32 off), written from
the published descriptions of the models, importing nothing of the port.
``Numerics("fp8")`` turns it into the control."""
