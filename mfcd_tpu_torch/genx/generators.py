"""Ground-truth matrix generators.

Counterpart of ``mfcd_tpu/genx/generators.py`` (``haar_frame``,
``generate_base``).  Each is a function of a threefry key
(``mfcd_tpu_torch.core.prng``) that broadcasts over leading key
dimensions: a key ``[R, 2]`` yields ``[R, n, m]``.  The other generators
are not ported yet (ROADMAP M14).
"""

from __future__ import annotations

import torch

from mfcd_tpu_torch.core import prng


def haar_frame(key: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """Random n x d orthonormal frame, Haar-distributed.

    QR of an i.i.d. Gaussian with the R-diagonal sign fix gives the first d
    columns of a Haar orthogonal matrix."""
    g = prng.normal(key, (n, d))
    q, r = torch.linalg.qr(g)
    sign = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    return q * sign.unsqueeze(-2)


def generate_base(key: torch.Tensor, n: int, m: int, d: int) -> torch.Tensor:
    """``generation="base"``: X = U S V^T with Haar frames, singular values
    1/sqrt(d), scaled by sqrt(n*m)/2 (reference
    ``generation_data.py:346-370``)."""
    ku, kv = prng.split(key).unbind(-2)
    u = haar_frame(ku, n, d)
    v = haar_frame(kv, m, d)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=key.device)
    scale = torch.sqrt(f32(n * m)) / 2.0 / torch.sqrt(f32(d))
    return (u @ v.transpose(-1, -2)) * scale

