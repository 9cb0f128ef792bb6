"""Iteration scheduler, lease recovery, multi-worker film merge, CLI."""
import numpy as np
import pytest

from oppositerenderer.config import RenderConfig, RenderMethod
from oppositerenderer.parallel.distributed import (IterationScheduler,
                                                       MultiHostRenderer,
                                                       merge_films)
from oppositerenderer.renderer import Renderer
from oppositerenderer.scene import make_cornell_small


def test_scheduler_hands_out_disjoint_packets():
    s = IterationScheduler(total_iterations=10, packet_size=4)
    _, a = s.acquire("w0", now=0.0)
    _, b = s.acquire("w1", now=0.0)
    _, c = s.acquire("w0", now=0.0)
    assert a == (0, 1, 2, 3)
    assert b == (4, 5, 6, 7)
    assert c == (8, 9)
    assert not s.done
    s.complete(0, a); s.complete(0, b); s.complete(0, c)
    assert s.done


def test_scheduler_lease_expiry_reassigns():
    """A dead worker's iterations get re-leased (capability the reference
    lacks: its lost iterations stall the merge forever)."""
    s = IterationScheduler(total_iterations=8, packet_size=4,
                           lease_seconds=10.0)
    seq, a = s.acquire("w0", now=0.0)    # 0-3, expires at t=10
    _, b = s.acquire("w1", now=0.0)      # 4-7
    s.complete(seq, b)
    # w0 dies; at t=11 its lease expires and w1 picks the work up
    _, c = s.acquire("w1", now=11.0)
    assert c == a
    s.complete(seq, c)
    assert s.done


def test_scheduler_sequence_bump_drops_stale():
    s = IterationScheduler(total_iterations=8, packet_size=4)
    seq, a = s.acquire("w0", now=0.0)
    s.bump_sequence()
    assert not s.complete(seq, a)        # stale result discarded
    seq2, a2 = s.acquire("w0", now=0.0)
    assert a2 == (0, 1, 2, 3)
    assert s.complete(seq2, a2)


def test_scheduler_flow_control():
    s = IterationScheduler(total_iterations=100, packet_size=4)
    got = []
    for _ in range(10):
        _, its = s.acquire("w0", now=0.0)
        got.append(its)
    # 30-pending cap: packets 8 and beyond come back empty
    active = [g for g in got if g]
    assert sum(len(g) for g in active) <= 30


def test_multiworker_merge_equals_single():
    """Two simulated workers splitting iterations reproduce the
    single-renderer film exactly (iteration radiance is a pure function of
    iteration number + seed)."""
    scene, cam = make_cornell_small()
    cfg = RenderConfig(width=24, height=24,
                       render_method=RenderMethod.PATH_TRACING)

    ref = Renderer(scene, cam, cfg, seed=9)
    ref.render(6)

    w0 = MultiHostRenderer(scene, cam, cfg, seed=9)
    w1 = MultiHostRenderer(scene, cam, cfg, seed=9)
    w0.render_iterations((0, 2, 4))
    w1.render_iterations((1, 3, 5))
    merged = merge_films([
        (np.asarray(w0.local_film().accum), 3),
        (np.asarray(w1.local_film().accum), 3)])
    assert int(merged.iterations) == 6
    np.testing.assert_allclose(np.asarray(merged.accum),
                               np.asarray(ref.film.accum), rtol=1e-5,
                               atol=1e-6)


def test_scheduler_driven_run():
    scene, cam = make_cornell_small()
    cfg = RenderConfig(width=16, height=16,
                       render_method=RenderMethod.PATH_TRACING)
    sched = IterationScheduler(total_iterations=5, packet_size=2)
    w = MultiHostRenderer(scene, cam, cfg, seed=1)
    film = w.run(5, scheduler=sched)
    assert sched.done
    assert int(film.iterations) == 5
    assert w.stats["iterations"] == 5
    assert np.isfinite(np.asarray(film.accum)).all()


def test_cli_end_to_end(tmp_path):
    from oppositerenderer.cli import main
    out = tmp_path / "cli.png"
    ckpt = tmp_path / "cli.npz"
    rc = main(["--scene", "CornellSmall", "--method", "pt", "--size", "24",
               "--iterations", "2", "--output", str(out),
               "--checkpoint", str(ckpt), "--quiet", "--cpu"])
    assert rc == 0
    assert out.exists() and ckpt.exists()
    # resume adds more iterations deterministically
    rc = main(["--scene", "CornellSmall", "--method", "pt", "--size", "24",
               "--iterations", "1", "--output", str(out),
               "--checkpoint", str(ckpt), "--resume", "--quiet", "--cpu"])
    assert rc == 0
    from oppositerenderer.film import load_checkpoint
    film, _, _, _ = load_checkpoint(ckpt)
    assert int(film.iterations) == 3
