"""The Plucker-matmul large-scene paths, opt-in through
``RenderConfig(large_scene_mode="mx")`` and ``"mx2"`` or by handing the
renderer a prebuilt ``MXSet`` / ``MX2Set``.

The port of ``pathtracer_cuda_interactive_tpu/experiments/``.  Both paths
intersect a packet of 128 rays with a group of triangles through one
product of the rays' 10 Plucker features with the triangles' coefficients
(mxset.py), and both ride the sorted-wavefront loop of ops/wavefront.py
(``render_waves``), which they share with the brick engines:

* "mx" (mxset.py, mxtrace.py): 128-triangle bricks, an interval cull of
  every packet against every brick box in torch ops, then rounds of one
  library product per packet and brick (``torch.bmm`` in full float32).
  It holds no hand-written kernel, as the JAX path holds no Pallas kernel.
* "mx2" (mx2set.py, mx2.py): 512-triangle superbricks in sub-bricks of 32,
  the same cull, and kernel B7 (csrc/mx2_trace.cu), which walks each
  packet's near-first superbrick list with a slab test per sub-brick and
  the product in its own body.

The default large-scene path stays the sorted wavefront with kernel B2.
How these two stand beside it on the card is a measurement: PERF.md holds
it, with the card's name and power limit.
"""
