"""Every arch's train and serve steps on every small mesh, on the CPU
(ROADMAP A11e): the ten archs, full and reduced, on each (1, data,
model) mesh with data <= 4 and model in {1, 2, 3, 4, 8}, each traced on
``meta`` tensors on the mesh's last rank (``_torch_layout``), with the
dimensions the axes do not split whole on every rank of them.  The
model code computes every block's shape there, so a gather, a sum or a
slice that does not fit the placement fails the case;
``tests/test_torch_clamp.py`` holds such placements' values against one
device and the JAX reference."""
import pytest
from _torch_layout import MODES, trace_layout
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.configs.registry import ARCH_IDS, get_config

GRID = [(a, red, (1, D, M), mode) for a in ARCH_IDS for red in (False, True)
        for D in (1, 2, 3, 4) for M in (1, 2, 3, 4, 8) if D * M > 1
        for mode in MODES]


def _id(x):
    if isinstance(x, bool):
        return "reduced" if x else "full"
    if isinstance(x, tuple):
        return "x".join(map(str, x))
    return str(x)


@pytest.mark.parametrize("arch,reduced,shape,mode", GRID, ids=_id)
def test_every_arch_traces_its_steps_on_the_grid(arch, reduced, shape,
                                                 mode):
    """The train step (forward, backward, gradient sums, update) or the
    prefill and the decode under each cache placement, on the rank's
    blocks: a dimension the axis splits cut into its block, one it does
    not whole."""
    cfg = get_config(arch)
    trace_layout(cfg.reduced() if reduced else cfg, shape, mode)
