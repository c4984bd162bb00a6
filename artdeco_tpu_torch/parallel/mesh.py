"""Device meshes for the multi-device path: one process, one controller.

The counterpart of ``jax.sharding.Mesh`` and of the ``psum`` / ``pmax`` /
``pmean`` collectives that ``artdeco_tpu/parallel`` runs inside
``shard_map``.  As a ``shard_map`` is one program over all of a process's
devices, here one host thread drives every slot of the mesh: a slot's work
runs on the slot's device, and a collective brings the per-slot tensors to
the mesh's first device (its home, where the model state lives) and
reduces them there in slot order 0..n-1, so its result does not depend on
which slot finished first.  No ``torch.distributed``: NCCL refuses two
ranks on one GPU, and a one-card machine must run this path too.

A mesh may name one device more than once: a virtual mesh, the counterpart
of XLA's virtual CPU devices.  ``Mesh([cuda:0] * 4)`` runs four slots on
one card, each slot on its own copies of the inputs, which drives the whole
multi-device path on a one-card machine; its times are those of four slots
sharing one card, not a scaling measurement.  ``make_mesh`` builds a
virtual mesh only on the CPU.
"""

from __future__ import annotations

from typing import Sequence

import torch


class Mesh:
    """A one-axis mesh of ``devices`` (slot i runs on ``devices[i]``)."""

    def __init__(self, devices: Sequence, axis: str = "dp"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self.shape = {axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """The first slot's device: the model state's, and where the
        collectives reduce."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"

    def replicate(self, x: torch.Tensor, slot: int) -> torch.Tensor:
        """Slot ``slot``'s replica of the home tensor ``x``: ``x`` itself on
        slot 0, a copy on the slot's device for every other slot (also
        where that device is the home's, as on a virtual mesh)."""
        return x if slot == 0 else x.to(self.devices[slot], copy=True)

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of per-slot tensors (in slot order; all slots or some), on
        the home device."""
        out = xs[0].to(self.home)
        for x in xs[1:]:
            out = out + x.to(self.home)
        return out

    def pmean(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The mean of one tensor per slot, on the home device."""
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} tensors for a mesh of {self.size} slots")
        return self.psum(xs) / self.size

    def pmax(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The elementwise max of per-slot tensors (for bool: the OR), on
        the home device."""
        out = xs[0].to(self.home)
        for x in xs[1:]:
            out = torch.maximum(out, x.to(self.home))
        return out


def make_mesh(n: int, device, axis: str = "dp") -> Mesh:
    """The mesh ``--n_devices n`` asks for: for a CUDA ``device`` the first
    ``n`` cards (``ValueError`` when there are fewer), for the CPU ``n``
    slots on the CPU (the tests' counterpart of the JAX package's forced
    host device count)."""
    device = torch.device(device)
    if device.type == "cuda":
        avail = torch.cuda.device_count()
        if avail < n:
            raise ValueError(f"--n_devices {n} but only {avail} devices")
        return Mesh([torch.device("cuda", i) for i in range(n)], axis)
    if device.type == "cpu":
        return Mesh([device] * n, axis)
    raise ValueError(f"make_mesh: unsupported device {device}")
