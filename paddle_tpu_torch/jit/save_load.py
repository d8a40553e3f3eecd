"""jit.save / jit.load: the exported-program artifact (counterpart of
paddle_tpu/jit/save_load.py).

`save(layer, path, input_spec)` exports ``layer.eval()`` with
`torch.export`, on the layer's device, as a function of its parameters
and buffers and then the inputs: the weights are arguments of the
program, never constants inside it, as in the reference (its holders).
Four files share the prefix `path`, with the reference's roles:

* ``.pdmodel``: the serialized `torch.export.ExportedProgram`
  (`torch.export.save`), with no weights in it;
* ``.pdiparams``: a pickle of numpy arrays keyed by the parameter and
  buffer names; bf16 tensors as their ``uint16`` bits (numpy has no
  bfloat16, and loading must not need a package beside numpy), their
  dtype in the meta;
* ``.pdmodel.json``: ``inputs`` (shape and dtype of each), ``param_names``
  and ``shardings`` (empty: the port records no placement), the
  reference's keys, plus ``param_dtypes``, ``device`` and ``num_outputs``;
* ``.pdmodel.txt``: the program as text (`str(ExportedProgram)`), in place
  of the reference's ``.stablehlo.mlir``.

The program calls the kernels through their `torch.library` operators
(``paddle_tpu_torch::flash_fwd``, ``paddle_tpu_torch::weight_only_matmul``;
`ops._library`), so it runs on either device and launches the kernels on
the GPU. `load(path, device=None)` returns a `TranslatedLayer` on `device`
(the GPU by default; raises without one). A program exported on the other
device is moved by torch's own pass
(`torch.export.passes.move_to_device_pass`), never traced again.

A `TranslatedLayer` runs the program eagerly per call (`__call__`), and
over `bucket` stacked examples as one program per bucket (`batched_call`,
`jit.aot`): on the GPU one CUDA graph replay a batch, each example's
outputs bit-identical to `__call__`'s.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import threading

import numpy as np
import torch

from .. import resolve_device
from . import aot

__all__ = ["save", "load", "TranslatedLayer", "SHARDING_ITEM"]

#: where tensor-parallel placement of a loaded program comes in
SHARDING_ITEM = ("ROADMAP Queue 1 item 6 (more than one device: "
                 "tensor parallelism over torch.distributed)")

def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def torch_dtype(name):
    """A dtype name of the meta ("float32", "int64", "bfloat16") as a
    torch dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"unknown dtype {name!r} in the artifact's meta")
    return dt


def _example(spec, device):
    """One input_spec entry -> a zero example tensor on `device`: a
    tensor or array (its shape and dtype), an object with ``shape`` and
    ``dtype`` (None or negative dims as 1, as the reference), or a
    (shape, dtype) pair."""
    if isinstance(spec, torch.Tensor):
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if isinstance(spec, np.ndarray):
        return torch.from_numpy(np.zeros_like(spec)).to(device)
    if hasattr(spec, "shape"):
        shape = [1 if (s is None or s < 0) else int(s) for s in spec.shape]
        dt = getattr(spec, "dtype", torch.float32)
    else:
        shape, dt = spec
        shape = [int(s) for s in shape]
    if not isinstance(dt, torch.dtype):
        dt = torch_dtype(np.dtype(dt).name if not isinstance(dt, str)
                         else dt)
    return torch.zeros(shape, dtype=dt, device=device)


class _Pure(torch.nn.Module):
    """The layer as a function of (parameters and buffers, inputs): the
    program `save` exports. The layer is held outside the module tree, so
    export lifts none of its tensors as the program's own state."""

    def __init__(self, layer, names):
        super().__init__()
        self._held = (layer,)
        self._names = names

    def forward(self, *args):
        n = len(self._names)
        return torch.func.functional_call(
            self._held[0], dict(zip(self._names, args[:n])), tuple(args[n:]))


def _layer_device(layer):
    for t in list(layer.parameters()) + list(layer.buffers()):
        return t.device
    return torch.device("cpu")


def _to_numpy(t):
    """(array, dtype name): bf16 as its uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
    return t.numpy().copy(), _dtype_name(t.dtype)


def _from_numpy(a, dtype_name, device):
    a = np.ascontiguousarray(a)
    if dtype_name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def save(layer, path, input_spec=None, **configs):
    """Export ``layer.forward`` over `input_spec` (a list of example
    tensors or arrays, objects with shape and dtype, or (shape, dtype)
    pairs) to the four files of prefix `path`, on the layer's device."""
    if input_spec is None:
        raise ValueError("jit.save requires input_spec: the exported "
                         "program is specialized to its shapes")
    if configs:
        raise TypeError(f"jit.save: unsupported options {sorted(configs)}")
    device = _layer_device(layer)
    examples = [_example(s, device) for s in input_spec]
    named = dict(layer.named_parameters())
    named.update(layer.named_buffers())
    names = list(named)
    holders = [named[n].detach() for n in names]

    was_training = layer.training
    layer.eval()
    try:
        with torch.no_grad():
            ep = torch.export.export(_Pure(layer, names),
                                     tuple(holders) + tuple(examples))
    finally:
        layer.train(was_training)
    ep.example_inputs = None             # the weights stay out of the file
    buf = io.BytesIO()
    torch.export.save(ep, buf)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    params, dtypes = {}, {}
    for n, h in zip(names, holders):
        params[n], dt = _to_numpy(h)
        if dt == "bfloat16":
            dtypes[n] = dt
    n_out = sum(1 for s in ep.graph_signature.output_specs
                if s.kind == torch.export.graph_signature.OutputKind
                .USER_OUTPUT)
    meta = {
        "inputs": [{"shape": list(e.shape), "dtype": _dtype_name(e.dtype)}
                   for e in examples],
        "param_names": names,
        "shardings": {},
        "param_dtypes": dtypes,
        "device": device.type,
        "num_outputs": n_out,
    }
    with open(path + ".pdmodel", "wb") as f:
        f.write(buf.getvalue())
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump(params, f, protocol=4)
    with open(path + ".pdmodel.json", "w") as f:
        json.dump(meta, f)
    with open(path + ".pdmodel.txt", "w") as f:
        f.write(str(ep))


class TranslatedLayer:
    """A loaded exported program (reference: TranslatedLayer). The program
    is the artifact: no Python body of the model is needed. Its weights
    live on the layer (`state_dict`, `set_state_dict`); every Predictor
    clone and every bucket program reads them from here."""

    def __init__(self, params, meta, program_text, exported, fingerprint,
                 device):
        self.device = device
        self._param_names = list(params)
        self._params = dict(params)
        self._meta = meta
        self._text = program_text
        self._exported = exported
        self._module = exported.module()
        self._fold_module = None         # jit.aot's "fold" body, on demand
        self._fingerprint = fingerprint
        self._aot_lock = threading.Lock()
        self._aot_programs = {}
        self._aot_building = {}          # bucket -> Event (build in flight)
        self._aot_counts = {"compiles": 0, "disk_hits": 0, "mem_hits": 0}

    def _holders(self):
        return [self._params[n] for n in self._param_names]

    def _inputs(self, inputs):
        spec = self.input_spec
        if len(inputs) != len(spec):
            raise ValueError(f"expected {len(spec)} input(s), got "
                             f"{len(inputs)}")
        vals = []
        for x, s in zip(inputs, spec):
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            vals.append(t.to(device=self.device,
                             dtype=torch_dtype(s["dtype"])))
        return vals

    @torch.no_grad()
    def __call__(self, *inputs):
        """Run the program on `inputs` (tensors or arrays of the exported
        shapes, cast to the exported dtypes): on the GPU as the bucket-1
        program (one CUDA graph replay, as the reference runs its compiled
        module), on the CPU eagerly. Returns a tensor, or a tuple of them
        for a program of several outputs."""
        if self.device.type != "cuda":
            return self.eager(*inputs)
        inputs = [x if hasattr(x, "shape") else np.asarray(x)
                  for x in inputs]
        if len(inputs) != len(self.input_spec):
            raise ValueError(f"expected {len(self.input_spec)} input(s), "
                             f"got {len(inputs)}")
        for x, s in zip(inputs, self.input_spec):
            if tuple(x.shape) != tuple(s["shape"]):
                raise ValueError(f"input of shape {tuple(x.shape)}, the "
                                 f"exported program takes {s['shape']}")
        outs = self._program(1)[0].run(*(x[None] for x in inputs))
        outs = tuple(o[0].clone() for o in outs)
        return outs[0] if len(outs) == 1 else outs

    @torch.no_grad()
    def eager(self, *inputs):
        """Run the program op by op (the exported graph's torch calls on
        the layer's device); returns what the program returns."""
        return self._module(*self._holders(), *self._inputs(inputs))

    forward = __call__

    def state_dict(self):
        return dict(self._params)

    @torch.no_grad()
    def set_state_dict(self, state):
        """Copy new values into the weights in place (so built bucket
        programs, which read these tensors, serve them too); names the
        program does not take are ignored, a shape mismatch raises. Call
        it between requests."""
        for k, v in state.items():
            if k not in self._params:
                continue
            dst = self._params[k]
            src = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                np.asarray(v))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{k}: shape {tuple(src.shape)} does not "
                                 f"fit the program's {tuple(dst.shape)}")
            dst.copy_(src.to(device=dst.device, dtype=dst.dtype))

    def shard_(self, mesh, rules=None, registry=None):
        raise NotImplementedError(
            f"TranslatedLayer.shard_ (tensor-parallel serving of a loaded "
            f"program) is not ported to paddle_tpu_torch yet; it comes with "
            f"{SHARDING_ITEM}")

    @property
    def input_spec(self):
        return self._meta["inputs"]

    @property
    def input_dtypes(self):
        """The torch dtype of each input."""
        return [torch_dtype(s["dtype"]) for s in self.input_spec]

    @property
    def num_outputs(self):
        return self._meta.get("num_outputs")

    @property
    def program_text(self):
        return self._text

    @property
    def graph_ops(self):
        """The operators the program calls, by name (``aten.linear.default``,
        ``paddle_tpu_torch.flash_fwd.default``, ...)."""
        return sorted({str(n.target) for n in self._exported.graph.nodes
                       if n.op == "call_function"})

    @property
    def fingerprint(self):
        """sha256 of the ``.pdmodel`` bytes."""
        return self._fingerprint

    # -- bucket programs (jit.aot) ----------------------------------------
    def batched_call(self, bucket, cache=None):
        """`fn(*stacked_inputs) -> tuple of stacked numpy outputs` running
        the program over `bucket` stacked examples (a leading axis) as one
        bucket program: on the GPU one CUDA graph replay. Built once per
        bucket per layer (concurrent callers wait for the one build) and
        shared by every clone. Each example's outputs are bit-identical
        to `__call__`'s (bf16 outputs come back as float32, exactly).
        `cache` is refused: see `jit.aot.CompileCache`."""
        aot.refuse_cache(cache)
        prog, built = self._program(bucket)
        if not built:
            with self._aot_lock:
                self._aot_counts["mem_hits"] += 1
        return prog

    def _program(self, bucket):
        """(the bucket's program, whether this call built it): built on
        first use, concurrent callers waiting for the one build."""
        with self._aot_lock:
            prog = self._aot_programs.get(bucket)
            if prog is not None:
                return prog, False
            ev = self._aot_building.get(bucket)
            first = ev is None
            if first:
                ev = self._aot_building[bucket] = threading.Event()
        if not first:
            ev.wait()
            with self._aot_lock:
                prog = self._aot_programs.get(bucket)
                if prog is not None:
                    return prog, False
            # the build failed: retry (one waiter builds)
            return self._program(bucket)
        try:
            prog = aot.compile_batched(self, bucket)
            with self._aot_lock:
                self._aot_programs[bucket] = prog
                self._aot_counts["compiles"] += 1
            return prog, True
        finally:
            with self._aot_lock:
                self._aot_building.pop(bucket, None)
            ev.set()

    def warmup_buckets(self, buckets, cache=None):
        """Build every bucket's program up front, so traffic builds none."""
        for b in sorted({int(b) for b in buckets}):
            self.batched_call(b, cache=cache)

    def aot_stats(self):
        """{"buckets", "compiles" (programs built), "disk_hits" (always 0:
        no disk cache), "mem_hits"}."""
        with self._aot_lock:
            return {"buckets": sorted(self._aot_programs),
                    **dict(self._aot_counts)}


class _ArtifactUnpickler(pickle.Unpickler):
    """Unpickles a parameter archive: numpy arrays and builtins only."""

    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes":
            raise ValueError(
                f"the parameter archive holds {module}.{name} arrays (a JAX "
                f"artifact's bfloat16 weights), which need the ml_dtypes "
                f"package to unpickle; paddle_tpu_torch reads numpy only: "
                f"export the JAX model in float32")
        if module.split(".")[0] not in ("numpy", "builtins", "collections",
                                        "_codecs"):
            raise ValueError(f"unexpected {module}.{name} in a parameter "
                             f"archive")
        return super().find_class(module, name)


def read_params(path):
    """The ``.pdiparams`` of prefix `path` as {name: np.ndarray}."""
    with open(path + ".pdiparams", "rb") as f:
        return _ArtifactUnpickler(f).load()


def read_meta(path):
    with open(path + ".pdmodel.json") as f:
        return json.load(f)


def load(path, device=None, **configs):
    """Load the artifact of prefix `path` onto `device` (the GPU by
    default; raises without one; ``device="cpu"`` on purpose)."""
    if configs:
        raise TypeError(f"jit.load: unsupported options {sorted(configs)}")
    dev = resolve_device(device)
    meta = read_meta(path)
    raw = read_params(path)
    dtypes = meta.get("param_dtypes", {})
    params = {n: _from_numpy(raw[n], dtypes.get(n), dev)
              for n in meta["param_names"]}
    with open(path + ".pdmodel", "rb") as f:
        blob = f.read()
    with open(path + ".pdmodel.txt") as f:
        text = f.read()
    ep = torch.export.load(io.BytesIO(blob))
    if meta.get("device", "cpu") != dev.type:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, dev)
    return TranslatedLayer(params, meta, text, ep,
                           hashlib.sha256(blob).hexdigest(), dev)
