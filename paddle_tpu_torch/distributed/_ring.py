"""Transport of the context-parallel mesh: the port's counterpart of the
``ppermute``, ``all_to_all`` and ``psum`` that the JAX package's
shard_map bodies call, over one `torch.distributed` process group.

* `Transport.shift` sends tensors to rank p + 1 and receives the same
  shapes from p - 1 (one ring hop), `shift(..., -1)` the other way;
* `Transport.all_to_all` splits a tensor along one dim into one piece per
  rank and concatenates what the ranks send back along another (Ulysses);
* `Transport.all_reduce_` sums a tensor over the group in place (the
  loss and the gradients).

Point-to-point traffic goes through `dist.batch_isend_irecv`, and every
message is one flat byte buffer (the tensors of a hop packed, each 16-byte
aligned), so any dtype crosses any backend. NCCL carries CUDA tensors as
they are. Gloo carries host memory only: with a gloo group, CUDA tensors
are staged through pinned host buffers — copied to the host before a
send, back to the device after a receive. That is the transport the
caller chose by its backend, counted in `stats` (bytes and host
milliseconds per kind), never a silent fallback.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["Transport"]

_ALIGN = 16


def _nbytes(t):
    return t.numel() * t.element_size()


def _padded(n):
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _pack(tensors, device):
    """The tensors as one uint8 buffer, each at a 16-byte offset."""
    total = sum(_padded(_nbytes(t)) for t in tensors)
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    off = 0
    for t in tensors:
        n = _nbytes(t)
        buf[off:off + n].copy_(t.contiguous().reshape(-1).view(torch.uint8))
        off += _padded(n)
    return buf


def _unpack(buf, like):
    out, off = [], 0
    for t in like:
        n = _nbytes(t)
        out.append(buf[off:off + n].view(t.dtype).view(t.shape))
        off += _padded(n)
    return out


class _Pending:
    """A started exchange; `wait()` returns what arrived."""

    def __init__(self, transport, kind, reqs, recvs, finish, t0, nbytes,
                 sends=()):
        self._t, self._kind, self._reqs = transport, kind, reqs
        self._sends = sends         # alive until the sends complete
        self._recvs, self._finish = recvs, finish
        self._t0, self._nbytes = t0, nbytes
        self._ms = (time.perf_counter() - t0) * 1e3

    def wait(self):
        t0 = time.perf_counter()
        for r in self._reqs:
            r.wait()
        out = self._finish(self._recvs)
        self._t._count(self._kind, self._nbytes,
                       self._ms + (time.perf_counter() - t0) * 1e3)
        return out


class Transport:
    """Point-to-point and collective exchange on one process group for
    tensors on `device`; ``staged`` is True where CUDA tensors cross a
    gloo group through pinned host memory."""

    def __init__(self, group, device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group)).lower()
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.backend not in ("nccl",
                                                               "gloo"):
            raise ValueError(f"backend {self.backend!r} for CUDA tensors: "
                             f"use nccl, or gloo (staged through the host)")
        if self.device.type == "cpu" and self.backend != "gloo":
            raise ValueError(f"backend {self.backend!r} for CPU tensors: "
                             f"use gloo")
        self.staged = self.device.type == "cuda" and self.backend == "gloo"
        self._pinned = {}
        self.stats = {}
        self.reset_stats()

    def reset_stats(self):
        """Zero the counts: per kind ("shift", "all_to_all",
        "all_reduce") the calls, the bytes this rank sent and the host
        milliseconds spent in the exchange (staging copies included)."""
        self.stats = {k: {"calls": 0, "bytes": 0, "ms": 0.0}
                      for k in ("shift", "all_to_all", "all_reduce")}

    def _count(self, kind, nbytes, ms):
        st = self.stats[kind]
        st["calls"] += 1
        st["bytes"] += int(nbytes)
        st["ms"] += ms

    def _peer(self, r):
        return dist.get_global_rank(self.group, r % self.size)

    def _host(self, key, nbytes):
        """A pinned host buffer of at least `nbytes` (kept per key)."""
        buf = self._pinned.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._pinned[key] = buf
        return buf[:nbytes]

    def _wire(self, buf, key):
        """What goes on the wire for a device buffer: itself, or (staged)
        its copy in a pinned host buffer."""
        if not self.staged:
            return buf
        host = self._host(key, buf.numel())
        host.copy_(buf)
        return host

    def _land(self, buf):
        return buf.to(self.device) if self.staged else buf

    # -- ring hop --------------------------------------------------------
    def start_shift(self, tensors, direction=1):
        """Start one hop: send `tensors` to rank p + direction, receive the
        same shapes and dtypes from p - direction. Returns a handle whose
        `wait()` gives the received tensors."""
        t0 = time.perf_counter()
        send = self._wire(_pack(tensors, self.device), "send")
        recv = (self._host("recv", send.numel()) if self.staged
                else torch.empty_like(send))
        ops = [dist.P2POp(dist.isend, send, self._peer(self.rank + direction),
                          self.group),
               dist.P2POp(dist.irecv, recv, self._peer(self.rank - direction),
                          self.group)]
        reqs = dist.batch_isend_irecv(ops)
        return _Pending(self, "shift", reqs, recv,
                        lambda r: _unpack(self._land(r), tensors), t0,
                        send.numel(), (send,))

    def shift(self, tensors, direction=1):
        return self.start_shift(tensors, direction).wait()

    # -- Ulysses -----------------------------------------------------------
    def all_to_all(self, x, split_dim, concat_dim):
        """Piece j of `x` along `split_dim` goes to rank j; the pieces
        received from ranks 0..n-1 are concatenated along `concat_dim`."""
        t0 = time.perf_counter()
        n = self.size
        pieces = list(torch.chunk(x, n, dim=split_dim))
        if len({p.shape for p in pieces}) != 1 or len(pieces) != n:
            raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                             f"split into {n} equal pieces")
        ops, recvs, sends, sent = [], {}, [], 0
        for j in range(n):
            if j == self.rank:
                continue
            send = self._wire(_pack([pieces[j]], self.device), f"a2a{j}")
            recv = (self._host(f"a2r{j}", send.numel()) if self.staged
                    else torch.empty_like(send))
            recvs[j] = recv
            sends.append(send)
            sent += send.numel()
            ops += [dist.P2POp(dist.isend, send, self._peer(j), self.group),
                    dist.P2POp(dist.irecv, recv, self._peer(j), self.group)]
        reqs = dist.batch_isend_irecv(ops) if ops else []

        def finish(recvs):
            got = [pieces[j].contiguous() if j == self.rank
                   else _unpack(self._land(recvs[j]), [pieces[j]])[0]
                   for j in range(n)]
            return torch.cat(got, dim=concat_dim)

        return _Pending(self, "all_to_all", reqs, recvs, finish, t0,
                        sent, sends).wait()

    # -- sums --------------------------------------------------------------
    def all_reduce_(self, t):
        """Sum `t` over the group, in place (every rank gets the same
        bits); returns `t`."""
        t0 = time.perf_counter()
        if self.staged:
            host = self._host("reduce", _nbytes(t)).view(t.dtype)
            host = host[:t.numel()].view(t.shape)
            host.copy_(t)
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        self._count("all_reduce", _nbytes(t),
                    (time.perf_counter() - t0) * 1e3)
        return t
