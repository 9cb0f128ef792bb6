import sys
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import time, json, jax, jax.numpy as jnp
from oppositerenderer.config import RenderConfig, RenderMethod
from oppositerenderer.renderer import Renderer
from oppositerenderer.scene import get_scene_by_name

scene, camera = get_scene_by_name("Atrium")
for G in (1, 5):
    cfg = RenderConfig(width=512, height=512,
                       render_method=RenderMethod.PATH_TRACING,
                       iterations_per_dispatch=5, iteration_batch=G)
    r = Renderer(scene, camera, cfg, seed=0)
    t0 = time.perf_counter(); r.render(5); compile_s = time.perf_counter()-t0
    times = []
    for _ in range(3):
        r.restart()
        t0 = time.perf_counter(); r.render(5); times.append(time.perf_counter()-t0)
    times.sort()
    print(json.dumps(dict(G=G, ms_per_iter=round(times[1]/5*1000,2),
                          min=round(times[0]/5*1000,2),
                          compile_s=round(compile_s,1))))
