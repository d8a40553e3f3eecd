"""Automatic mixed precision (counterpart of paddle_tpu/amp/__init__.py):
`auto_cast` (`amp_guard`), `decorate`, `GradScaler`, the op lists and
`amp_state()`.

The policy is the reference's `_should_cast`: under an enabled
`auto_cast`, a black-listed op runs in float32; under O1 a white-listed
op runs in the AMP dtype and every other op as its operands are; under
O2 every op that is not black-listed runs in the AMP dtype;
`custom_white_list` / `custom_black_list` add names to the lists. An op
"runs in" a dtype when its floating-point tensor operands are cast to it
on entry (integer operands, such as an embedding's indices, are left
alone).

The reference applies the policy in its op dispatcher, by op name. The
port's models call torch directly, so the policy is applied at the
torch-function level: inside `auto_cast`, a `TorchFunctionMode` maps the
torch callables below to the reference's op names (``F.linear`` to
"linear", ``Tensor.__matmul__`` and ``torch.matmul`` to "matmul",
``torch.softmax`` to "softmax", ``Tensor.add`` to "add", ...) and casts
at those entry points only; other torch calls pass through. The port's
own functionals that are one op of the reference (`layer_norm`,
`rms_norm`, `batch_norm`, `cross_entropy`, `dropout`, attention — the
kernel wrappers' callers, white as "sdpa") are marked with `amp_op`:
their operands are cast on entry and their bodies run with the policy
suspended, so a loss's f32 pass or a kernel's plain version is not cast
op by op. `torch.autocast` does not fit: its op lists are not Paddle's.

The state is per thread, as the reference's is, and so is the torch
function mode: a decode engine's scheduler thread runs its steps (and
its CUDA-graph captures) outside any caller's `auto_cast`.

Arguments the reference accepts and ignores raise `NotImplementedError`
when set: `auto_cast(use_promote=False)`, `decorate`'s `master_weight`
and `save_dtype`, and level "O0" (the reference treats it as O1).
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "amp_guard", "amp_op",
           "amp_state", "decorate", "GradScaler", "is_float16_supported",
           "is_bfloat16_supported"]

# per-op lists (the reference's, amp/__init__.py)
WHITE_LIST = {
    "matmul", "linear", "conv", "conv_bias", "conv_transpose",
    "conv_transpose_bias", "einsum", "sdpa", "sdpa_mask", "sdpa_cp", "bmm",
    "mm",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "cross_entropy", "cross_entropy_w", "mse_loss",
    "l1_loss", "norm", "sum", "mean", "cumsum", "logsumexp", "layer_norm",
    "batch_norm_train", "batch_norm_infer", "rms_norm",
}

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}
_T = torch.Tensor


def _torch_ops():
    """{torch callable: the reference's op name} for the entry points the
    mode casts at."""
    table = {
        "linear": [F.linear],
        "matmul": [torch.matmul, _T.matmul, _T.__matmul__, _T.__rmatmul__],
        "mm": [torch.mm, _T.mm],
        "bmm": [torch.bmm, _T.bmm],
        "einsum": [torch.einsum],
        "conv": [F.conv1d, F.conv2d, F.conv3d],
        "conv_transpose": [F.conv_transpose1d, F.conv_transpose2d,
                           F.conv_transpose3d],
        "sdpa": [F.scaled_dot_product_attention],
        "exp": [torch.exp, _T.exp],
        "log": [torch.log, _T.log],
        "log2": [torch.log2, _T.log2],
        "log10": [torch.log10, _T.log10],
        "log1p": [torch.log1p, _T.log1p],
        "pow": [torch.pow, _T.pow, _T.__pow__, _T.__rpow__],
        "square": [torch.square, _T.square],
        "sqrt": [torch.sqrt, _T.sqrt],
        "rsqrt": [torch.rsqrt, _T.rsqrt],
        "softmax": [torch.softmax, _T.softmax, F.softmax],
        "log_softmax": [torch.log_softmax, _T.log_softmax, F.log_softmax],
        "cross_entropy": [F.cross_entropy],
        "mse_loss": [F.mse_loss],
        "l1_loss": [F.l1_loss],
        "norm": [torch.norm, _T.norm, torch.linalg.vector_norm,
                 torch.linalg.norm],
        "sum": [torch.sum, _T.sum],
        "mean": [torch.mean, _T.mean],
        "cumsum": [torch.cumsum, _T.cumsum],
        "logsumexp": [torch.logsumexp, _T.logsumexp],
        "layer_norm": [F.layer_norm],
        "batch_norm_train": [F.batch_norm],
        "rms_norm": [F.rms_norm],
        "add": [torch.add, _T.add, _T.__add__, _T.__radd__],
        "subtract": [torch.sub, torch.subtract, _T.sub, _T.__sub__,
                     _T.__rsub__],
        "multiply": [torch.mul, torch.multiply, _T.mul, _T.__mul__,
                     _T.__rmul__],
        "divide": [torch.div, torch.divide, torch.true_divide, _T.div,
                   _T.__truediv__, _T.__rtruediv__],
        "gelu": [F.gelu],
        "relu": [F.relu, torch.relu, _T.relu],
        "silu": [F.silu],
        "tanh": [torch.tanh, _T.tanh],
        "sigmoid": [torch.sigmoid, _T.sigmoid],
        "embedding": [F.embedding],
        "concat": [torch.cat, torch.concat],
        "stack": [torch.stack],
        "dropout": [F.dropout],
    }
    return {fn: name for name, fns in table.items() for fn in fns}


_OPS = _torch_ops()


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.float16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()
        self.suspended = 0          # > 0 inside an `amp_op` body


_amp = _AmpState()


def amp_state():
    return _amp


def _dtype(d):
    if isinstance(d, torch.dtype):
        return d
    if d not in _DTYPES:
        raise ValueError(f"unsupported AMP dtype {d!r}")
    return _DTYPES[d]


def _should_cast(name):
    """The reference's policy: the dtype op `name` runs in, or None."""
    if not _amp.enabled:
        return None
    if name in _amp.custom_black or name in BLACK_LIST:
        return torch.float32
    if _amp.level == "O2":
        return _amp.dtype
    if name in _amp.custom_white or name in WHITE_LIST:
        return _amp.dtype
    return None


def _cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return (x.to(dtype) if x.is_floating_point() and x.dtype != dtype
                else x)
    if isinstance(x, (list, tuple)):
        return type(x)(_cast(v, dtype) for v in x)
    return x


def _cast_args(name, args, kwargs):
    dtype = _should_cast(name)
    if dtype is None:
        return args, kwargs
    return (_cast(args, dtype),
            {k: _cast(v, dtype) for k, v in kwargs.items()})


class _CastMode(TorchFunctionMode):
    """Casts the operands of the mapped torch calls by the policy."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = None if _amp.suspended else _OPS.get(func)
        if name is not None:
            args, kwargs = _cast_args(name, args, kwargs)
        return func(*args, **kwargs)


def amp_op(name):
    """Mark a port function as the reference's op `name`: under
    `auto_cast` its float operands are cast by the policy on entry and its
    body runs with the policy suspended — and with torch-function
    dispatch off, which saves the mode's per-call cost on every torch
    call of the body."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _amp.enabled or _amp.suspended:
                return fn(*args, **kwargs)
            args, kwargs = _cast_args(name, args, kwargs)
            _amp.suspended += 1
            try:
                with torch._C.DisableTorchFunction():
                    return fn(*args, **kwargs)
            finally:
                _amp.suspended -= 1
        return wrapped
    return deco


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="float16", use_promote=True):
    """Paddle's `amp.auto_cast`: run the block under the cast policy of
    `level` ("O1" or "O2") and `dtype` ("float16" or "bfloat16")."""
    if level not in ("O1", "O2"):
        raise NotImplementedError(
            f"auto_cast(level={level!r}): the port takes 'O1' and 'O2' (the "
            f"reference treats any other level as O1)")
    if not use_promote:
        raise NotImplementedError(
            "auto_cast(use_promote=False): the reference accepts the "
            "argument and ignores it; the port refuses it")
    prev = (_amp.enabled, _amp.dtype, _amp.level, _amp.custom_white,
            _amp.custom_black)
    _amp.enabled = bool(enable)
    _amp.dtype = _dtype(dtype)
    _amp.level = level
    _amp.custom_white = set(custom_white_list or ())
    _amp.custom_black = set(custom_black_list or ())
    try:
        with _CastMode() if enable else contextlib.nullcontext():
            yield
    finally:
        (_amp.enabled, _amp.dtype, _amp.level, _amp.custom_white,
         _amp.custom_black) = prev


amp_guard = auto_cast


@torch.no_grad()
def decorate(models, optimizers=None, level="O1", dtype="float16",
             master_weight=None, save_dtype=None):
    """Paddle's `amp.decorate`: under O2, cast every float parameter of
    the models to `dtype` in place (the same `Parameter` objects, so an
    optimizer built over them keeps them; a gradient already there is
    cast too). O1 leaves the models as they are. Returns the models (and
    the optimizers, when given)."""
    for arg, val in (("master_weight", master_weight),
                     ("save_dtype", save_dtype)):
        if val is not None:
            raise NotImplementedError(
                f"decorate({arg}={val!r}): the reference accepts the "
                f"argument and ignores it; the port refuses it")
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        d = _dtype(dtype)
        for m in model_list:
            for p in m.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(d)
                    if p.grad is not None:
                        p.grad = p.grad.to(d)
    elif level != "O1":
        raise NotImplementedError(f"decorate(level={level!r}): the port "
                                  f"takes 'O1' and 'O2'")
    out = models if single else model_list
    return out if optimizers is None else (out, optimizers)


class GradScaler:
    """Dynamic loss scaling (the reference's GradScaler): `scale(loss)`
    multiplies by the scale; `step(optimizer)` unscales the gradients
    (unless `unscale_` already did this step) and steps the optimizer
    only when every gradient is finite — a skipped step leaves the
    parameters, the slots and the optimizer's step counter as they were;
    `update()` halves the scale after `decr_every_n_nan_or_inf` bad steps
    (not below 1) and doubles it after `incr_every_n_steps` good ones.
    The unscale is one multi-tensor multiply, the finite check one
    multi-tensor f32 L1 norm, and the flag one host read a step."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide the optimizer's gradients by the scale in place and note
        whether any is not finite."""
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        self._found_inf = False
        if grads:
            torch._foreach_mul_(grads, 1.0 / self._scale)
            # an inf or a NaN anywhere makes its tensor's f32 L1 norm
            # non-finite (so would a finite total over 3.4e38)
            total = torch.stack(torch._foreach_norm(
                grads, 1, dtype=torch.float32)).sum()
            self._found_inf = not bool(torch.isfinite(total))
        self._unscaled = True

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        self._unscaled = False
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        """Restore every key `state_dict` writes (the reference keeps its
        own ratios and drops the saved ones)."""
        self._scale = state.get("scale", self._scale)
        self._incr_ratio = state.get("incr_ratio", self._incr_ratio)
        self._decr_ratio = state.get("decr_ratio", self._decr_ratio)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


def is_float16_supported(device=None):
    return True


def is_bfloat16_supported(device=None):
    return True
