"""Multi-host distribution: iteration sharding, leases, film merge.

The reference's distribution layer is a TCP star: a client hands each render
server packets of iteration numbers with pre-computed PPM radii, servers
render whole frames, the client folds results back in global iteration order
(``Client/DistributedApplication.cpp:96-122``, ``RenderServerConnection.cpp``,
``RenderResultPacketReceiver.cpp:67-148``). Its fault story: stale work is
dropped via sequence numbers, but a lost server's iterations are never
reassigned — the PPM merge waits forever (SURVEY.md section 5).

Redesign:

* Transport: ``jax.distributed`` (the device interconnect within a host,
  the network across hosts) instead of Qt TCP; the "client merge" is a psum/weighted average.
* Iteration sharding stays (it is a good axis — proven by the reference),
  but because our per-iteration radiance uses the Knaus-Zwicker radius for
  *that* iteration (a pure function of the iteration number,
  renderer.ppm_radius_sq_at_iteration), merging is ORDER-INDEPENDENT —
  the reference's sorted back-buffer machinery is unnecessary.
* Fault recovery the reference lacks: :class:`IterationScheduler` leases
  iteration ranges to workers; expired leases are reassigned, so a lost
  host costs only its in-flight work. Flow control mirrors the reference's
  limits (packets of 4 iterations, bounded in-flight work).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import jax
import numpy as np

from ..camera import Camera
from ..config import RenderConfig
from ..film import Film
from ..renderer import Renderer
from ..scene.types import Scene

# reference flow-control constants (DistributedApplication.cpp:31,
# RenderServerConnection.cpp:37-48)
ITERATIONS_PER_PACKET = 4
MAX_PENDING_PER_WORKER = 30


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """jax.distributed.initialize wrapper (no-op when single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


@dataclass
class _Lease:
    iterations: tuple[int, ...]
    worker: str
    expires: float


@dataclass
class IterationScheduler:
    """Lease-based iteration assignment (client-side work handout analog,
    plus the reassignment the reference lacks).

    Workers call :meth:`acquire` for a packet of iteration numbers and
    :meth:`complete` when rendered. Leases that outlive ``lease_seconds``
    are handed to other workers. A :meth:`bump_sequence` drops all pending
    state (the reference's sequence-number invalidation,
    Application.cpp:119-127)."""

    total_iterations: int
    packet_size: int = ITERATIONS_PER_PACKET
    lease_seconds: float = 60.0
    sequence_number: int = 0
    _next: int = 0
    _completed: set = field(default_factory=set)
    _leases: dict = field(default_factory=dict)   # first_iter -> _Lease
    _pending_reassign: list = field(default_factory=list)
    _worker_stats: dict = field(default_factory=dict)  # worker -> counters

    def acquire(self, worker: str, now: float | None = None
                ) -> tuple[int, tuple[int, ...]]:
        """Returns (sequence_number, iteration numbers) — empty when done."""
        now = time.monotonic() if now is None else now
        self._expire(now)
        # bounded in-flight per worker (reference: <=30 pending iterations)
        pending = sum(len(l.iterations) for l in self._leases.values()
                      if l.worker == worker)
        if pending + self.packet_size > MAX_PENDING_PER_WORKER:
            return self.sequence_number, ()
        if self._pending_reassign:
            its = self._pending_reassign.pop(0)
        else:
            its = tuple(
                i for i in range(self._next,
                                 min(self._next + self.packet_size,
                                     self.total_iterations)))
            self._next += len(its)
        if not its:
            return self.sequence_number, ()
        self._leases[its[0]] = _Lease(its, worker, now + self.lease_seconds)
        return self.sequence_number, its

    def complete(self, sequence_number: int, iterations: tuple[int, ...]
                 ) -> bool:
        """Returns False when the work is stale (sequence bumped) and must
        be discarded (RenderServerConnection.cpp:185-212 stale drop)."""
        if sequence_number != self.sequence_number or not iterations:
            return False
        lease = self._leases.pop(iterations[0], None)
        self._completed.update(iterations)
        if lease is not None:
            w = self._worker_stats.setdefault(
                lease.worker, {"iterations": 0, "packets": 0})
            w["iterations"] += len(iterations)
            w["packets"] += 1
        return True

    def worker_stats(self) -> list[dict]:
        """Per-worker farm table rows (the ConnectedServersTableModel
        analog, Client/gui_models/ConnectedServersTableModel.cpp): worker
        name, completed iterations/packets, currently-pending iterations.
        Feed to viewer.RenderService(farm_stats=scheduler.worker_stats)."""
        pending: dict[str, int] = {}
        for lease in self._leases.values():
            pending[lease.worker] = (pending.get(lease.worker, 0)
                                     + len(lease.iterations))
        names = sorted(set(self._worker_stats) | set(pending))
        return [{"worker": w,
                 "iterations": self._worker_stats.get(
                     w, {}).get("iterations", 0),
                 "packets": self._worker_stats.get(w, {}).get("packets", 0),
                 "pending": pending.get(w, 0)}
                for w in names]

    def _expire(self, now: float) -> None:
        for first, lease in list(self._leases.items()):
            if lease.expires <= now:
                del self._leases[first]
                self._pending_reassign.append(lease.iterations)

    def bump_sequence(self) -> int:
        """Camera/scene change: all outstanding work becomes stale."""
        self.sequence_number += 1
        self._next = 0
        self._completed.clear()
        self._leases.clear()
        self._pending_reassign.clear()
        return self.sequence_number

    @property
    def done(self) -> bool:
        return len(self._completed) >= self.total_iterations

    @property
    def completed_count(self) -> int:
        return len(self._completed)


def merge_films(films_and_counts: list[tuple[np.ndarray, int]]) -> Film:
    """Order-independent weighted merge (the
    mergeBufferRunningAverage analog, RenderResultPacketReceiver.cpp:169-196,
    without the ordering requirement — see module docstring)."""
    import jax.numpy as jnp
    total = None
    n = 0
    for accum, count in films_and_counts:
        total = accum if total is None else total + accum
        n += count
    return Film(accum=jnp.asarray(total), iterations=jnp.asarray(n))


class MultiHostRenderer:
    """Iteration-sharded rendering across jax processes (or simulated
    workers in one process). Each worker owns a :class:`Renderer` and
    renders the iteration numbers the scheduler leases to it; films merge
    order-independently."""

    def __init__(self, scene: Scene, camera: Camera, cfg: RenderConfig,
                 seed: int = 0):
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.seed = seed
        self.process_index = jax.process_index()
        self.process_count = jax.process_count()
        self._renderer = Renderer(scene, camera, cfg, seed=seed)
        self._accum = None
        self._count = 0
        self.stats: dict[str, Any] = {"packets": 0, "iterations": 0,
                                      "render_seconds": 0.0}

    def render_iterations(self, iterations: tuple[int, ...]) -> None:
        """Render specific global iteration numbers into the local film
        (server-side onNewRenderCommandInQueue analog)."""
        import jax.numpy as jnp
        r = self._renderer
        t0 = time.perf_counter()
        diffs = {iterations[i + 1] - iterations[i]
                 for i in range(len(iterations) - 1)}
        if len(iterations) > 1 and len(diffs) == 1:
            # arithmetic progression (scheduler packets are contiguous;
            # SPMD mode strides by process count): ONE fused dispatch
            rad_sum, _stats = r.compute_iterations(
                iterations[0], len(iterations), stride=diffs.pop())
            self._accum = rad_sum if self._accum is None else \
                self._accum + rad_sum
            self._count += len(iterations)
        else:
            for it in iterations:
                radiance, _stats = r.compute_iteration(it)
                safe = jnp.where(jnp.isfinite(radiance), radiance, 0.0)
                self._accum = safe if self._accum is None else \
                    self._accum + safe
                self._count += 1
        self.stats["packets"] += 1
        self.stats["iterations"] += len(iterations)
        self.stats["render_seconds"] += time.perf_counter() - t0

    def reset(self) -> None:
        """Drop accumulated work (sequence-bump analog / post-warmup)."""
        self._accum = None
        self._count = 0
        self.stats = {"packets": 0, "iterations": 0, "render_seconds": 0.0}

    def warmup(self) -> None:
        """Compile + execute the exact paths :meth:`run` uses — the fused
        multi-iteration dispatch (traced n/stride: one compile serves every
        count) and the cross-process film merge — then reset, so a timed
        ``run`` measures render throughput, not XLA compiles. The reference
        similarly excludes its 60 s OptiX JIT from render timing
        (README.md:78)."""
        self.render_iterations(tuple(range(self.process_index,
                                           self.process_count * 2,
                                           self.process_count)))
        # tiered compile: let the background throughput executable land so
        # the timed region measures steady state (Renderer tiering)
        self._renderer.wait_for_compile_upgrade()
        np.asarray(self.merged_film().accum)
        self.reset()

    def local_film(self) -> Film:
        import jax.numpy as jnp
        accum = self._accum if self._accum is not None else jnp.zeros(
            (self.cfg.height, self.cfg.width, 3))
        return Film(accum=accum, iterations=jnp.asarray(self._count))

    def merged_film(self) -> Film:
        """All-process merge via a cross-host ALL-REDUCE of the film sum
        (2x frame traffic, vs the reference shipping every worker's full
        frame to the client — RenderServerRenderer.cpp:166-173 — and vs a
        process_allgather's D x frame). Single-process: the local film."""
        if self.process_count == 1:
            return self.local_film()
        import jax.numpy as jnp
        from jax.experimental import multihost_utils
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        local = self.local_film()
        mesh = Mesh(np.asarray(jax.devices()), ("proc",))
        # one shard per process along the leading axis -> jit sum with a
        # replicated output = XLA all-reduce across hosts
        payload = jnp.concatenate(
            [local.accum.reshape(-1),
             jnp.asarray([local.iterations], jnp.float32).reshape(-1)])
        glob = multihost_utils.host_local_array_to_global_array(
            payload[None], mesh, P("proc"))
        summed = jax.jit(
            lambda a: jnp.sum(a, axis=0),
            out_shardings=NamedSharding(mesh, P()))(glob)
        out = np.asarray(multihost_utils.global_array_to_host_local_array(
            summed, mesh, P()))
        h, w = self.cfg.height, self.cfg.width
        return Film(accum=jnp.asarray(out[:h * w * 3].reshape(h, w, 3)),
                    iterations=jnp.asarray(int(round(float(out[-1])))))

    def run(self, total_iterations: int,
            scheduler: IterationScheduler | None = None) -> Film:
        """Drive the render to completion for this worker. With a shared
        scheduler (tests/farm mode) work is leased; otherwise iterations
        stride across processes (SPMD mode: worker w gets w, w+P, ...)."""
        if scheduler is None:
            mine = tuple(range(self.process_index, total_iterations,
                               self.process_count))
            self.render_iterations(mine)
            return self.merged_film()
        name = f"worker{self.process_index}"
        while not scheduler.done:
            seq, its = scheduler.acquire(name)
            if not its:
                break
            self.render_iterations(its)
            scheduler.complete(seq, its)
        return self.merged_film()
