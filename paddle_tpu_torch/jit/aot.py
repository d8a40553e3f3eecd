"""Bucket programs of a loaded exported program (counterpart of
paddle_tpu/jit/aot.py `compile_batched`).

The reference builds, for one exported module and one bucket size B, one
XLA executable mapping B stacked examples to B stacked outputs: a
`lax.map` of the module over the examples, so each example runs exactly
the program a single call runs and its outputs are bit-identical, in one
dispatch. Here a bucket program is a `StepProgram`
(`paddle_tpu_torch._graphs`): static input buffers of shape
``[B, *input_shape]``, a body, and on the GPU one CUDA graph of that body,
captured once; a call stacks the examples into the static inputs (through
pinned host memory: nothing is copied from the host inside the capture),
replays the graph and copies the outputs back.

The body is fixed in code by the device and the program's operators
(`bucket_design`), never chosen at run time:

* ``"fold"``, on the GPU for a program whose every operator is in
  `FOLDED` or `PER_EXAMPLE`: `torch.func.vmap` of the program over the
  stacked axis, with the operators that sum taken out of the fold. An
  elementwise, indexing or view operator folds (a CUDA elementwise kernel
  applies one function to each element, whatever their count), and so do
  the two kernel operators: their vmap rules fold the axis into the flash
  forward's batch and the weight-only product's rows, whose kernels sum
  each row in one order whatever the rows beside it (the weight-only rule
  keeps each example's route). Every operator that sums across elements,
  a library product (cuBLAS picks its kernel, and so a row's summation
  order, by the row count) or a reduction, runs once per example at its
  single call's shape (the `per_example` operator, whose vmap rule is a
  loop). So each example's outputs are its single call's bits by
  construction, and a bucket launches each folded operator once;
* ``"loop"``, on the CPU, and on the GPU for a program with any other
  operator: the program once per example, B times in one program, so
  every operator has a single call's shapes (the CPU's vectorized math
  also changes which elements take its scalar tail with their count).

A CUDA graph has no serialized form, so there is no persistent cache of
bucket programs: `CompileCache` and ``cache=`` are refused (the same
decision as the decode engine's ``compile_cache=``), and every
process builds its programs (`TranslatedLayer.warmup_buckets`,
``aot_stats()["disk_hits"]`` is 0). The kernels' nvcc build is cached on
disk already (`ops._build`).
"""
from __future__ import annotations

import operator
import threading

import torch

from .._graphs import StepProgram, counted_wrappers
from ..ops import _library

__all__ = ["BucketProgram", "CompileCache", "FOLDED", "PER_EXAMPLE",
           "bucket_design", "compile_batched", "host_array", "per_example",
           "refuse_cache", "NO_DISK_CACHE"]

#: operators the "fold" body runs once over the stacked examples:
#: elementwise, indexing and view operators, and the kernel operators
FOLDED = frozenset({
    "getitem", "aten._assert_tensor_metadata.default",
    "aten.add.Tensor", "aten.add.Scalar", "aten.sub.Tensor",
    "aten.sub.Scalar", "aten.rsub.Scalar", "aten.mul.Tensor",
    "aten.mul.Scalar", "aten.div.Tensor", "aten.div.Scalar",
    "aten.neg.default", "aten.abs.default", "aten.exp.default",
    "aten.log.default", "aten.sqrt.default", "aten.rsqrt.default",
    "aten.square.default", "aten.pow.Tensor_Scalar", "aten.tanh.default",
    "aten.sigmoid.default", "aten.relu.default", "aten.gelu.default",
    "aten.silu.default", "aten.erf.default", "aten.where.self",
    "aten.clamp.default", "aten.maximum.default", "aten.minimum.default",
    "aten.eq.Scalar", "aten.ne.Scalar", "aten.lt.Scalar", "aten.gt.Scalar",
    "aten.to.dtype", "aten._to_copy.default", "aten.type_as.default",
    "aten.dropout.default", "aten.one_hot.default",
    "aten.embedding.default", "aten.arange.default", "aten.arange.start",
    "aten.full.default", "aten.zeros.default", "aten.ones.default",
    "aten.reshape.default", "aten.view.default", "aten.unsqueeze.default",
    "aten.squeeze.dim", "aten.select.int", "aten.slice.Tensor",
    "aten.unbind.int", "aten.split.Tensor", "aten.chunk.default",
    "aten.permute.default", "aten.transpose.int", "aten.t.default",
    "aten.expand.default", "aten.contiguous.default", "aten.clone.default",
    "aten.flatten.using_ints", "aten.cat.default", "aten.stack.default",
    "paddle_tpu_torch.flash_fwd.default",
    "paddle_tpu_torch.weight_only_matmul.default"})

#: operators of one tensor output that the "fold" body runs once per
#: example: the library products and the reductions
PER_EXAMPLE = frozenset({
    "aten.linear.default", "aten.matmul.default", "aten.mm.default",
    "aten.addmm.default", "aten.bmm.default", "aten.baddbmm.default",
    "aten.einsum.default", "aten.conv1d.default", "aten.conv2d.default",
    "aten.scaled_dot_product_attention.default",
    "aten.sum.dim_IntList", "aten.sum.default", "aten.mean.dim",
    "aten.mean.default", "aten.amax.default", "aten.amin.default",
    "aten.softmax.int", "aten._softmax.default", "aten.log_softmax.int",
    "aten.logsumexp.default", "aten.var.correction", "aten.std.correction",
    "aten.layer_norm.default", "aten.group_norm.default",
    "aten.cumsum.default"})


def _op_name(target):
    if target is operator.getitem:
        return "getitem"
    return str(target)


class _Slot:
    """The place of the i-th tensor argument in a `per_example` call's
    recorded arguments."""

    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


# A torch.library operator takes no Python callable, so `per_example`
# takes the index of a recorded call: (operator, args, kwargs), appended
# once per rewritten node of a loaded program, never removed.
_CALLS = []
_CALLS_LOCK = threading.Lock()


def _fill(a, tensors):
    if isinstance(a, _Slot):
        return tensors[a.i]
    if isinstance(a, (list, tuple)):
        return type(a)(_fill(x, tensors) for x in a)
    if isinstance(a, dict):
        return {k: _fill(v, tensors) for k, v in a.items()}
    return a


def _per_example_call(key, tensors):
    op, args, kwargs = _CALLS[key]
    return op(*_fill(args, tensors), **_fill(kwargs, tensors))


def _per_example_vmap(info, in_dims, key, tensors):
    """The recorded operator once per example, on each example's slices:
    the single call's shapes."""
    dims = in_dims[1]
    outs = [_per_example_call(key, [t if d is None else t.select(d, j)
                                    for t, d in zip(tensors, dims)])
            for j in range(info.batch_size)]
    return torch.stack(outs), 0


#: ``paddle_tpu_torch::per_example``: recorded operator `key` (a node of a
#: "fold" body, never exported) on `tensors`; under vmap, once per example
per_example = _library.define(
    "per_example", "(int key, Tensor[] tensors) -> Tensor",
    cpu=_per_example_call, cuda=_per_example_call, fake=_per_example_call,
    vmap=_per_example_vmap)


def bucket_design(layer):
    """The body of `layer`'s bucket programs (see the module docstring):
    "fold" on the GPU where every operator of the program is in `FOLDED`,
    or in `PER_EXAMPLE` with one tensor output; "loop" otherwise."""
    if layer.device.type != "cuda":
        return "loop"
    for node in layer._module.graph.nodes:
        if node.op != "call_function":
            continue
        name = _op_name(node.target)
        if name in FOLDED:
            continue
        if name in PER_EXAMPLE and isinstance(node.meta.get("val"),
                                              torch.Tensor):
            continue
        return "loop"
    return "fold"


def _fold_module(layer):
    """A fresh module of `layer`'s program whose `PER_EXAMPLE` nodes call
    `per_example` (built once per layer)."""
    with _CALLS_LOCK:
        if layer._fold_module is not None:
            return layer._fold_module
        gm = layer._exported.module()
        for node in gm.graph.nodes:
            if node.op != "call_function" \
                    or _op_name(node.target) not in PER_EXAMPLE:
                continue
            tensors = []

            def slot(n, tensors=tensors):
                tensors.append(n)
                return _Slot(len(tensors) - 1)

            args = torch.fx.node.map_arg(node.args, slot)
            kwargs = torch.fx.node.map_arg(dict(node.kwargs), slot)
            _CALLS.append((node.target, args, kwargs))
            node.target = per_example
            node.args, node.kwargs = (len(_CALLS) - 1, tensors), {}
        gm.recompile()
        layer._fold_module = gm
        return gm


NO_DISK_CACHE = (
    "a persistent compile cache of bucket programs is not ported, by "
    "decision: the JAX cache stores compiled XLA executables on disk, and "
    "a CUDA graph has no serialized form, so paddle_tpu_torch builds each "
    "bucket program once per process (TranslatedLayer.warmup_buckets / "
    "ServingPool.warmup; aot_stats()['disk_hits'] is 0); the CUDA kernels' "
    "build is cached on disk already")


class CompileCache:
    """Refused: see `NO_DISK_CACHE`."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(NO_DISK_CACHE)


def refuse_cache(cache):
    if cache is not None:
        raise NotImplementedError(NO_DISK_CACHE)


def _outputs(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _staged(dtype):
    return torch.int16 if dtype == torch.bfloat16 else dtype


def host_array(t):
    """A device output as an owning numpy array (bf16 as float32, which
    holds every bf16 value exactly: numpy has no bfloat16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


class BucketProgram:
    """`fn(*stacked_inputs) -> tuple of numpy outputs` over `bucket`
    stacked examples of `layer` (a `TranslatedLayer`). One call at a time
    (the static buffers are the program's): concurrent callers of one
    bucket take turns; other buckets run beside it."""

    def __init__(self, layer, bucket, _design=None):
        if bucket < 1:
            raise ValueError(f"bucket size must be >= 1, got {bucket}")
        design = _design or bucket_design(layer)
        if design not in ("loop", "fold"):
            raise ValueError(f"unknown bucket design {design!r}")
        self.bucket = n = int(bucket)
        self.design = design
        spec = layer.input_spec
        names = self._names = [f"input_{i}" for i in range(len(spec))]
        dtypes = self._dtypes = layer.input_dtypes
        # bf16 inputs are staged as their int16 bits (numpy has no bf16)
        fields = [(name, (n, *s["shape"]), _staged(dt), 0)
                  for name, s, dt in zip(names, spec, dtypes)]
        module = _fold_module(layer) if design == "fold" else layer._module
        holders = layer._holders()

        def run_one(*xs):
            return _outputs(module(*holders, *xs))

        # the body holds no reference to this object: a graph is freed
        # with its program, never by a garbage collection that may run
        # inside another program's capture
        def body(t):
            xs = [t[name].view(dt) for name, dt in zip(names, dtypes)]
            if design == "fold":
                outs = _outputs(torch.func.vmap(run_one)(*xs))
            else:
                per = [run_one(*(x[j] for x in xs)) for j in range(n)]
                outs = [torch.stack(col) for col in zip(*per)]
            return {f"output_{k}": o for k, o in enumerate(outs)}

        self._lock = threading.Lock()
        with torch.no_grad():
            self._prog = StepProgram(f"bucket-{bucket}", fields, body,
                                     layer.device)
            if layer.device.type == "cuda":
                # a private memory pool: buckets may run on several
                # workers at once
                self._prog.capture(None, counted_wrappers())

    @property
    def graph(self):
        """True when a call is a CUDA graph replay."""
        return self._prog.graph

    def __call__(self, *stacked):
        """The outputs as owning numpy arrays."""
        return self._replay(stacked, host_array)

    def run(self, *stacked):
        """The outputs as device tensors of their own (copies of the
        program's static outputs)."""
        return self._replay(stacked, torch.clone)

    @torch.no_grad()
    def _replay(self, stacked, out):
        if len(stacked) != len(self._names):
            raise ValueError(f"expected {len(self._names)} stacked input(s), "
                             f"got {len(stacked)}")
        with self._lock:
            arrays = self._prog.stage()
            for n, dt, x in zip(self._names, self._dtypes, stacked):
                dst = arrays[n]
                src = torch.as_tensor(x).detach().to("cpu", dt)
                if tuple(src.shape) != dst.shape:
                    raise ValueError(f"{n}: stacked shape "
                                     f"{tuple(src.shape)}, the bucket "
                                     f"program takes {dst.shape}")
                dst[...] = src.view(_staged(dt)).numpy()
            outs = self._prog.run()
            return tuple(out(outs[f"output_{k}"]) for k in range(len(outs)))


def compile_batched(layer, bucket, _design=None):
    """Build `layer`'s program over `bucket` stacked examples (on the GPU,
    its CUDA graph), with the body `bucket_design` fixes (`_design`
    overrides it for the tests). `TranslatedLayer.batched_call` builds
    each bucket once and shares it."""
    return BucketProgram(layer, bucket, _design)
