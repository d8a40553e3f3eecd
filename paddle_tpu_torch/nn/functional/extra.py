"""Vision functionals (counterpart of paddle_tpu/nn/functional/extra.py's
`channel_shuffle`)."""
from __future__ import annotations

__all__ = ["channel_shuffle"]


def channel_shuffle(x, groups, data_format="NCHW"):
    """ShuffleNet's channel shuffle: the channels, read as ``[groups,
    C / groups]``, are transposed, so channel ``g * (C / groups) + i``
    moves to ``i * groups + g``. NCHW or NHWC."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    groups = int(groups)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
        .reshape(n, h, w, c)
