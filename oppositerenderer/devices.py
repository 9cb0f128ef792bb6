"""Compute-device enumeration — the ComputeDeviceRepository analog.

The reference enumerates CUDA devices with their properties (name, compute
capability, memory, SM count, PCI ids) and maps a user-picked CUDA ordinal to
an OptiX ordinal (``RenderEngine/ComputeDevice.{h,cpp}``,
``ComputeDeviceRepository.cpp:11-23``, ``OptixRenderer.cpp:404-432``;
Standalone prompts for the pick at startup, ``Standalone/standalone.cpp``).

Here the runtime is JAX: devices come from ``jax.devices()`` and carry
platform/kind/process/coords metadata plus live device-memory statistics. This module
wraps them in the same repository shape so the CLI can list devices and pick
one (``--list-devices`` / ``--device N``), and so the multi-host layer can
report per-host device tables the way the reference's server reported its
device name in the handshake (``Server/server/RenderServer.cpp:74-91``).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ComputeDevice:
    """One accelerator (the reference's ComputeDevice, ComputeDevice.h)."""

    ordinal: int                 # position in jax.devices() — the pick index
    name: str                    # device kind, e.g. "NVIDIA H100 80GB HBM3"
    platform: str                # "gpu" / "cpu"
    process_index: int           # owning host (multi-host)
    local_ordinal: int           # ordinal among this process's devices
    coords: tuple | None         # mesh coordinates, if the runtime exposes them
    core_on_chip: int | None
    memory_total: int | None     # bytes of HBM, if the runtime reports it
    memory_in_use: int | None

    @property
    def is_local(self) -> bool:
        import jax
        return self.process_index == jax.process_index()

    def summary(self) -> str:
        mem = ""
        if self.memory_total:
            used = (self.memory_in_use or 0) / 2**30
            mem = f"  {used:.2f}/{self.memory_total / 2**30:.2f} GiB HBM"
        coords = f"  coords={self.coords}" if self.coords is not None else ""
        return (f"[{self.ordinal}] {self.name} ({self.platform}) "
                f"host={self.process_index}{coords}{mem}")


def _stat(stats: dict | None, key: str) -> int | None:
    if not stats:
        return None
    v = stats.get(key)
    return int(v) if v is not None else None


@dataclass
class ComputeDeviceRepository:
    """Enumerates available accelerators (ComputeDeviceRepository.cpp:11-23).

    Unlike the CUDA version there is no ordinal remapping to do — the JAX
    device IS the handle passed to jit/sharding — so ``pick`` returns the
    live ``jax.Device`` alongside its descriptor.
    """

    devices: list[ComputeDevice] = field(default_factory=list)
    _raw: list = field(default_factory=list, repr=False)

    @classmethod
    def enumerate(cls) -> "ComputeDeviceRepository":
        import jax

        repo = cls()
        for i, d in enumerate(jax.devices()):
            try:
                stats = d.memory_stats()
            except Exception:       # CPU backend has none
                stats = None
            repo.devices.append(ComputeDevice(
                ordinal=i,
                name=getattr(d, "device_kind", d.platform),
                platform=d.platform,
                process_index=d.process_index,
                local_ordinal=getattr(d, "local_hardware_id", None) or 0,
                coords=getattr(d, "coords", None),
                core_on_chip=getattr(d, "core_on_chip", None),
                memory_total=_stat(stats, "bytes_limit"),
                memory_in_use=_stat(stats, "bytes_in_use"),
            ))
            repo._raw.append(d)
        return repo

    def __len__(self) -> int:
        return len(self.devices)

    def pick(self, ordinal: int) -> tuple[ComputeDevice, object]:
        """Descriptor + live jax.Device for a user-chosen ordinal (the
        analog of the reference's CUDA→OptiX ordinal mapping)."""
        if not 0 <= ordinal < len(self.devices):
            raise ValueError(
                f"device ordinal {ordinal} out of range 0..{len(self) - 1}")
        return self.devices[ordinal], self._raw[ordinal]

    def table(self) -> str:
        if not self.devices:
            return "(no devices)"
        return "\n".join(d.summary() for d in self.devices)
