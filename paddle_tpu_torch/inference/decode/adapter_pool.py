"""Paged LoRA adapter serving (counterpart of
paddle_tpu/inference/decode/adapter_pool.py).

Multi-tenant decode (S-LoRA / Punica): many fine-tunes share ONE resident
base model, and the per-tenant state — low-rank A/B weights — is paged
like KV blocks. `AdapterPool` keeps one slot-stacked tensor pair per
target projection on the engine's device,

    A_stack: [slots, in_features, rank]      f32
    B_stack: [slots, rank, out_features]     f32, pre-scaled by alpha/rank

with slot 0 reserved all zeros ("no adapter"). Each matched `nn.Linear` /
`WeightOnlyLinear` gets a forward hook that, inside an `adapter_context`
(entered by the engine around each model call), adds the per-sequence
delta from `ops.bgmv.lora_delta` and selects slot-0 rows back to the base
output bit for bit.

Host-side the pool follows the block pool's refcount idiom: `acquire`
pins a name's slot for an owner and returns ``(slot, generation)`` (the
signature the engine's prefix cache keys by); `load` of a name whose slot
is referenced writes a FRESH slot and repoints the name, so in-flight
sequences keep the weights they were admitted with; unreferenced named
slots are LRU-evicted under pressure; refcount misuse raises ValueError.

Slots are written in place (the JAX pool replaces its stacks wholesale):
a load only ever writes a slot no sequence references, under the pool's
lock, on the caller's current stream.
"""
from __future__ import annotations

import threading

import torch

from ... import resolve_device
from ...ops.bgmv import lora_delta
from ..serving import AdapterNotLoaded

__all__ = ["AdapterPool", "AdapterNotLoaded", "OutOfAdapterSlots",
           "adapter_context", "current_context", "DEFAULT_TARGETS"]

#: slot ids below this are never handed out (slot 0 = no-adapter lane)
RESERVED_SLOTS = 1

#: attention projections — the S-LoRA default target set for `gpt`
DEFAULT_TARGETS = ("qkv_proj", "out_proj")


class OutOfAdapterSlots(RuntimeError):
    """`load()` found no free slot and nothing evictable: every slot is
    pinned by live sequences (backpressure: retry after traffic drains)."""


_tls = threading.local()


class _AdapterContext:
    __slots__ = ("stacks", "ids", "base")

    def __init__(self, stacks, ids):
        self.stacks = stacks      # {layer name: (A_stack, B_stack)}
        self.ids = ids            # int32 0-d or [batch] slot ids (device)
        # rows at slot 0, shaped to select over [batch, s, out]: formed
        # once per model call, not once per hooked layer
        base = ids == 0
        self.base = base[:, None, None] if ids.dim() else base


class adapter_context:
    """Context manager the engine enters around each model call: the
    layers' hooks read the stacks and the slot ids from here."""

    def __init__(self, stacks, ids):
        self._ctx = _AdapterContext(stacks, ids)

    def __enter__(self):
        self._prev = getattr(_tls, "active", None)
        _tls.active = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _tls.active = self._prev
        return False


def current_context():
    return getattr(_tls, "active", None)


class AdapterPool:
    """Slot-stacked LoRA adapter registry for one base model.

    Args:
        model: the base model; sublayers whose leaf name contains a target
            fragment and that carry int ``in_features``/``out_features``
            get the delta hook.
        rank: LoRA rank shared by every adapter of the pool.
        slots: total device slots INCLUDING reserved slot 0.
        targets: leaf-name fragments selecting the projections.
        alpha: default LoRA alpha (scaling alpha / rank is folded into B).
        device: where the stacks live; default the GPU (raises without
            one). Must be the model's device.
    """

    def __init__(self, model, *, rank, slots=8, targets=DEFAULT_TARGETS,
                 alpha=None, device=None):
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        if slots < RESERVED_SLOTS + 1:
            raise ValueError(
                f"slots must be > {RESERVED_SLOTS} (slot 0 is the reserved "
                f"no-adapter lane), got {slots}")
        self.device = resolve_device(device)
        model_dev = getattr(model, "device", self.device)
        if model_dev != self.device:
            raise ValueError(f"model is on {model_dev}, adapter pool device "
                             f"is {self.device}")
        self.rank = int(rank)
        self.slots = int(slots)
        self.targets = tuple(targets)
        self.alpha = float(alpha) if alpha is not None else float(rank)
        self._lock = threading.Lock()

        #: matched sublayers: full name -> (in_features, out_features)
        self._layers = {}
        self._hooks = []
        for lname, sub in model.named_modules():
            leaf = lname.split(".")[-1]
            if not leaf or not any(t in leaf for t in self.targets):
                continue
            in_f = getattr(sub, "in_features", None)
            out_f = getattr(sub, "out_features", None)
            if not isinstance(in_f, int) or not isinstance(out_f, int):
                continue
            self._layers[lname] = (in_f, out_f)
            self._hooks.append(
                sub.register_forward_hook(self._make_hook(lname)))
        if not self._layers:
            raise ValueError(f"no sublayer matched targets {self.targets!r} "
                             f"— nothing for adapters to apply to")

        self._stacks = {
            lname: (torch.zeros((self.slots, in_f, self.rank),
                                dtype=torch.float32, device=self.device),
                    torch.zeros((self.slots, self.rank, out_f),
                                dtype=torch.float32, device=self.device))
            for lname, (in_f, out_f) in self._layers.items()}

        self._by_name = {}                  # adapter name -> slot
        self._info = {}                     # slot -> bookkeeping dict
        self._free = list(range(self.slots - 1, RESERVED_SLOTS - 1, -1))
        self._tick = 0                      # LRU clock
        self._generation = 0                # monotonic load stamp
        self.hits = 0
        self.misses = 0
        self.loads = 0
        self.evictions = 0
        self.swaps = 0
        self.releases = 0

    # -- hook ---------------------------------------------------------------

    def _make_hook(self, key):
        def hook(module, inputs, output):
            ctx = current_context()
            if ctx is None:
                return None               # adapter-free call: untouched
            ab = ctx.stacks.get(key)
            if ab is None:
                return None
            delta = lora_delta(inputs[0], ab[0], ab[1], ctx.ids)
            # slot-0 rows select the base output bit for bit
            return torch.where(ctx.base, output,
                               output + delta.to(output.dtype))
        return hook

    def detach(self):
        """Remove the forward hooks."""
        for h in self._hooks:
            h.remove()
        self._hooks = []

    # -- dispatch surface ---------------------------------------------------

    def stacks(self):
        """{layer name: (A_stack, B_stack)} for the engine's context."""
        with self._lock:
            return dict(self._stacks)

    @property
    def layers(self):
        """Matched layer names -> (in_features, out_features)."""
        return dict(self._layers)

    # -- load / evict / swap ------------------------------------------------

    def load(self, name, weights, alpha=None):
        """Load (or hot-reload) adapter `name` from ``{layer name: (A [in,
        rank], B [rank, out])}`` (numpy or JAX arrays, or tensors: a JAX
        adapter as it is) covering every matched layer. Returns the slot
        it landed in."""
        scale = (float(alpha) if alpha is not None else self.alpha) \
            / self.rank
        missing = set(self._layers) - set(weights)
        if missing:
            raise ValueError(f"adapter {name!r} is missing weights for "
                             f"matched layers {sorted(missing)}")
        staged = {}
        for lname, (in_f, out_f) in self._layers.items():
            a, b = weights[lname]
            a = torch.as_tensor(a, dtype=torch.float32)
            b = torch.as_tensor(b, dtype=torch.float32)
            if tuple(a.shape) != (in_f, self.rank) \
                    or tuple(b.shape) != (self.rank, out_f):
                raise ValueError(
                    f"adapter {name!r} layer {lname!r}: expected A "
                    f"{(in_f, self.rank)} / B {(self.rank, out_f)}, got "
                    f"{tuple(a.shape)} / {tuple(b.shape)}")
            staged[lname] = (a, b * scale)

        with self._lock:
            old = self._by_name.get(name)
            if old is not None and not self._info[old]["refs"]:
                slot = old                 # idle: reload in place
            else:
                slot = self._take_slot_locked()
                if old is not None:
                    # referenced: generation-stamped swap — the old slot
                    # stays pinned (anonymous) until its holders finish
                    self._info[old]["name"] = None
                    self.swaps += 1
            self._generation += 1
            self._tick += 1
            self._by_name[name] = slot
            self._info[slot] = {"name": name, "refs": {},
                                "generation": self._generation,
                                "stamp": self._tick}
            with torch.no_grad():
                for lname, (a_stack, b_stack) in self._stacks.items():
                    a, b = staged[lname]
                    a_stack[slot].copy_(a)
                    b_stack[slot].copy_(b)
            self.loads += 1
            return slot

    def _take_slot_locked(self):
        if self._free:
            return self._free.pop()
        # LRU-evict the least recently used NAMED, UNREFERENCED slot
        victims = [s for s, info in self._info.items()
                   if info["name"] is not None and not info["refs"]]
        if not victims:
            raise OutOfAdapterSlots(
                f"all {self.slots - RESERVED_SLOTS} adapter slots are pinned "
                f"by live sequences — retry after traffic drains")
        victim = min(victims, key=lambda s: self._info[s]["stamp"])
        del self._by_name[self._info[victim]["name"]]
        del self._info[victim]
        self.evictions += 1
        return victim

    def unload(self, name):
        """Explicitly evict an idle adapter. LOUD on a referenced one."""
        with self._lock:
            slot = self._by_name.get(name)
            if slot is None:
                raise AdapterNotLoaded(f"adapter {name!r} is not loaded")
            refs = self._info[slot]["refs"]
            if refs:
                raise ValueError(
                    f"adapter {name!r} (slot {slot}) is referenced by "
                    f"{sorted(refs)} — release before unloading")
            del self._by_name[name]
            del self._info[slot]
            self._free.append(slot)
            self.evictions += 1

    # -- refcounts ----------------------------------------------------------

    def acquire(self, name, owner):
        """Pin `name`'s slot for `owner`; returns (slot, generation)."""
        with self._lock:
            slot = self._by_name.get(name)
            if slot is None:
                self.misses += 1
                raise AdapterNotLoaded(f"adapter {name!r} is not loaded "
                                       f"(load() it, then resubmit)")
            info = self._info[slot]
            info["refs"][owner] = info["refs"].get(owner, 0) + 1
            self._tick += 1
            info["stamp"] = self._tick
            self.hits += 1
            return slot, info["generation"]

    def release(self, slot, owner):
        """Drop one of `owner`'s references on `slot`; a reference that was
        never taken raises ValueError."""
        with self._lock:
            info = self._info.get(slot)
            if info is None or owner not in info["refs"]:
                raise ValueError(f"owner {owner!r} holds no reference on "
                                 f"adapter slot {slot}")
            self._release_one_locked(slot, info, owner, all_refs=False)

    def release_owned(self, owner):
        """Drop every reference `owner` holds (idempotent teardown)."""
        n = 0
        with self._lock:
            for slot, info in list(self._info.items()):
                if owner in info["refs"]:
                    n += info["refs"][owner]
                    self._release_one_locked(slot, info, owner,
                                             all_refs=True)
        return n

    def _release_one_locked(self, slot, info, owner, *, all_refs):
        if all_refs or info["refs"][owner] <= 1:
            del info["refs"][owner]
        else:
            info["refs"][owner] -= 1
        self.releases += 1
        if info["name"] is None and not info["refs"]:
            # anonymous (swapped-out) slot lost its last holder
            del self._info[slot]
            self._free.append(slot)

    # -- observability ------------------------------------------------------

    def stats(self):
        with self._lock:
            per = {}
            for nm, slot in self._by_name.items():
                info = self._info[slot]
                per[nm] = {"slot": slot,
                           "generation": info["generation"],
                           "refs": sum(info["refs"].values()),
                           "holders": len(info["refs"]),
                           "stamp": info["stamp"]}
            usable = self.slots - RESERVED_SLOTS
            used = usable - len(self._free)
            return {
                "slots": usable,
                "used": used,
                "loaded": len(self._by_name),
                "pinned_anonymous": used - len(self._by_name),
                "occupancy": used / usable if usable else 0.0,
                "refs": sum(sum(i["refs"].values())
                            for i in self._info.values()),
                "hits": self.hits, "misses": self.misses,
                "loads": self.loads, "evictions": self.evictions,
                "swaps": self.swaps, "releases": self.releases,
                "rank": self.rank, "targets": len(self._layers),
                "adapters": per,
            }

    def __repr__(self):
        s = self.stats()
        return (f"AdapterPool(rank={self.rank}, slots={s['slots']}, "
                f"loaded={s['loaded']}, refs={s['refs']})")
