"""Device repository (ComputeDeviceRepository analog) + profiling utils."""
import time

import jax
import jax.numpy as jnp
import pytest

from oppositerenderer.core.profiling import BenchmarkTimer, pass_scope, trace
from oppositerenderer.devices import ComputeDeviceRepository


def test_repository_enumerates_all_devices():
    repo = ComputeDeviceRepository.enumerate()
    assert len(repo) == len(jax.devices())  # 8 virtual CPU devices
    for i, d in enumerate(repo.devices):
        assert d.ordinal == i
        assert d.platform == "cpu"
        assert d.is_local
    assert len(repo.table().splitlines()) == len(repo)


def test_repository_pick_returns_live_device():
    repo = ComputeDeviceRepository.enumerate()
    desc, dev = repo.pick(1)
    assert desc.ordinal == 1
    assert dev is jax.devices()[1]
    x = jax.device_put(jnp.ones(4), dev)
    assert x.devices() == {dev}
    with pytest.raises(ValueError):
        repo.pick(len(repo))


def test_pass_scope_inside_jit():
    @jax.jit
    def f(x):
        with pass_scope("my_render_pass"):
            return x * 2.0

    assert float(f(jnp.float32(3.0))) == 6.0
    # the scope must appear as a name prefix in the lowered HLO locations
    hlo = jax.jit(f).lower(jnp.float32(1.0)).as_text(debug_info=True)
    assert "my_render_pass" in hlo


def test_trace_none_is_noop():
    with trace(None):
        pass


def test_trace_captures_to_logdir(tmp_path):
    logdir = tmp_path / "prof"
    with trace(str(logdir)):
        jnp.ones(8).block_until_ready()
    # a plugin/trace event dir must have been produced
    assert any(logdir.rglob("*")), "no profile output written"


def test_benchmark_timer_pausable():
    t = BenchmarkTimer(start=True)
    time.sleep(0.02)
    t.pause()
    s1 = t.seconds
    assert s1 >= 0.015
    time.sleep(0.02)
    assert t.seconds == s1  # paused: no accumulation
    t.start()
    time.sleep(0.01)
    assert t.seconds > s1
    assert t.running
    t.restart()
    assert t.seconds < 0.01
