"""The JAX package's mesh train steps against its one-device step, on the
tiny D0 and global batch of tests/test_torch_parallel_spatial.py (128 px,
8 classes, a batch of 4) on the 8-device virtual CPU mesh.

Prints, for each mesh, the step's grad_norm beside the one-device step's
and the parameters beyond rtol 5e-4 / atol 1e-5 of the one-device step's
(tests/test_parallel.py:73-83's bars): the largest excess, its parameter,
and the count of elements beyond. It shows which distance the port's
(2, 2) spatial test cannot hold JAX's (2, 2) step to (JAX_2X2_MOVES
there). Run from the repository root:

    JAX_PLATFORMS=cpu python tests/jax_mesh_step_witness.py

(about three minutes of JAX compiles).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import conftest  # noqa: E402,F401  (the 8-device virtual CPU mesh)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_parallel_step import _batch  # noqa: E402
from test_torch_train_step import _jax_start  # noqa: E402

from ood_object_detection_tpu.ops.anchors import Anchors  # noqa: E402
from ood_object_detection_tpu.parallel import create_mesh  # noqa: E402
from ood_object_detection_tpu.train import make_train_step  # noqa: E402

MESHES = {"(4,) data": ((4,), ("data",), None),
          "(2, 2) data x spatial": ((2, 2), ("data", "spatial"), "spatial"),
          "(1, 4) data x spatial": ((1, 4), ("data", "spatial"), "spatial"),
          "(4, 1) data x spatial": ((4, 1), ("data", "spatial"), "spatial")}


def main():
    model, tx, tcfg, start = _jax_start()
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    anchors = Anchors.from_config(model.config)

    def run(**kw):
        step = make_train_step(model, tx, anchors, tcfg, donate=False,
                               freeze_bn="none", **kw)
        state, metrics = step(start, batch)
        return (jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, state.params))[0],
                float(metrics["grad_norm"]))
    one, one_norm = run()
    print(f"one device: grad_norm {one_norm}")
    for name, (shape, axes, spatial) in MESHES.items():
        mesh = create_mesh(shape, axes, devices=jax.devices()[:4])
        got, norm = run(mesh=mesh, spatial_axis=spatial)
        worst, where, beyond = 0.0, None, 0
        for (path, a), (_, b) in zip(got, one):
            excess = np.abs(a - b) - 1e-5 - 5e-4 * np.abs(b)
            if float(excess.max()) > worst:
                worst, where = float(excess.max()), jax.tree_util.keystr(path)
            beyond += int((excess > 0).sum())
        rel = abs(norm - one_norm) / one_norm
        print(f"{name}: grad_norm {norm} ({rel:.3g} relative); parameters "
              f"beyond the bars: {beyond} elements, "
              f"the largest excess {worst:.3g} in {where}")


if __name__ == "__main__":
    main()
