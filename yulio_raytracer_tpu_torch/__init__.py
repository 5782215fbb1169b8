"""yulio_raytracer_tpu_torch: the PyTorch/CUDA port of yulio_raytracer_tpu.

The JAX package stays the reference; every module here names its JAX
counterpart by file, and tests/test_torch_*.py hold each against it.  The
port imports torch and numpy, never jax.  Its kernels are CUDA C++ for
Hopper (sm_90a) in csrc/, built by nvcc at first use into build/kernels/
with a plain C interface.  They have one launch route: a wrapper checks
its arguments and calls a torch operator that ops/cuda_build.operator
declared (yrt::<name>, CUDA only), whose implementation is its module's
`launch`, the one place that knows the kernel's C interface; a profiler
links each kernel to the span around its call.  On CPU tensors each
wrapper runs its plain torch version instead.

Layers, from the entry point down:
  api          the entry points: api/output.py, the StartRT session
               (api/session.py), the CLI (api/cli.py), the progressive
               display loop (api/display.py) and the web viewer
               (api/viewer.py)
  renderer     render_frame: passes of camera-sample ray batches;
               render_progressive (checkpointed) and pick
  integrator   wavefront path tracer (NEE, Russian roulette) and the
               debug renderer
  cameras / sampling / shading / lights / film   per-ray math in torch;
               sampling/precomputed.py the reference's sample sets
  scene        SceneBuilder.commit(device=None: the card, quality=) ->
               TorchScene
  geometry     host-side packing and BVH build (numpy, native builder)
  ops          intersection: dense.py, wide.py, traverse.py, pairs.py,
               grid.py and splitleaf.py wrap the kernels; cuda_build.py
               builds, loads and declares them
  utils        logging, profiling (the render path's span tree, its
               tracer, traces, commit stats) and the random-scene
               fuzzer (utils/regression.py)
  parallel     pixel and triangle parallelism over devices and
               processes (sharding.py) and the TCP render servers
               (network.py)
  native       the C ABI shim (yuliort_shim.cpp) and its build

Tools beside the layers, none on the render path:
  turns        a family of this checkout's kernels against another
               checkout's, timed in turns on the card (`python -m
               yulio_raytracer_tpu_torch.turns FAMILY OTHER_ROOT`)
  wide_ab      the walks of one tree side by side on the card
  raysets      the ray sets and the recorded calls the tools time
  roofline     the card's peaks and the flops of one test
  profile_frame  one frame of a timed cell under torch.profiler
  proto_sublane_sweep  the dense-sweep layout prototype (K12)

Where a frame's time goes: `with profiling.tracing() as t:
render_frame(...)`, then `t.spans()` holds a record of every span of the
render path (utils/profiling.py has the tree), with its host times, its
parent, its frame serial and thread, and a bounce's counts (width, rays,
shadow, live), read with the frame's own ray count, so tracing adds no
host sync.  `profiling.trace(log_dir)` writes the same tree as ranges of
a Chrome trace beside the device's kernels, on one clock.
"""

__version__ = "0.1.0"
