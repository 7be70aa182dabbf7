"""Weight bridge: a JAX-package param tree (numpy leaves) -> the port's tree.

The port keeps the JAX layouts, so the bridge moves data and changes no
shape: dense ``w`` stays ``[in, out]``, conv ``w`` stays ``[K, in, out]``
(``conv_dw`` is ``[K, 1, D]``), 2-D conv ``w`` stays HWIO, and the encoder's
block leaves stay stacked ``[L, ...]``. One tree file therefore feeds both
packages. Leaves may be numpy arrays or anything ``np.asarray`` accepts
(a JAX array included), so the bridge needs no JAX import.
"""

import numpy as np
import torch

__all__ = ["params_from_numpy"]


def params_from_numpy(tree, device="cpu"):
    """Nested dict/list of arrays -> the same nesting of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)  # a writable copy
