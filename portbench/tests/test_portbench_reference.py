"""The reference against the program at a small size on the CPU: the
rounds of each traffic from the same inputs, and the packed mean against
the program's collective over 2, 3 and 4 devices.  (The test imports
both; the reference imports nothing of the program.)"""

import ast
import os

import pytest
import torch

from portbench import inputs, session, spec as speclib
from portbench.reference import flat
from portbench.tests.toy import toy_spec

CELLS = [w["name"] for w in speclib.benchmark()["workloads"]]
REF = os.path.join(speclib.HERE, "reference")


@pytest.mark.parametrize("cell", CELLS)
def test_reference_rounds_equal_the_programs(cell):
    spec = toy_spec(cell)
    st = session.start(spec, 11, "cpu")
    st.cell.close()
    ref = session.reference(spec, st, "cpu")
    nums = session.compare(spec, st.prog, ref, st.x_init)
    assert max(nums.values()) < 1e-5, nums


@pytest.mark.parametrize("D", [2, 3, 4])
def test_packed_mean_equals_the_programs_collective(D):
    from federated_pytorch_test_tpu_torch.ops.packed_reduce import (
        packed_fused_mean,
    )
    from federated_pytorch_test_tpu_torch.parallel.mesh import ClientMesh

    gen = torch.Generator().manual_seed(D)
    n, K = 3 * 256 * D + 77, 2 * D
    stack = torch.randn(K, n, generator=gen)
    mesh = ClientMesh(D)
    local = [s.sum(dim=0) for s in mesh.shards(stack)]
    prog = packed_fused_mean(local, torch.full((), float(K)), mesh, 8, 256)
    ref = flat.packed_mean(local, K, 127, 256)
    assert torch.equal(prog, ref)


def test_wire_order_round_trips():
    shapes = [(8, 4, 3, 3), (8,), (10, 8), (10,)]
    leaves = [torch.randn(s) for s in shapes]
    vec = flat.flatten(leaves)
    back = flat.unflatten(vec, [str(i) for i in range(4)], shapes)
    assert all(torch.equal(back[str(i)], t) for i, t in enumerate(leaves))


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(REF):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                top = m.split(".")[0]
                assert top in {"torch", "numpy", "portbench", "__future__",
                               "collections", "contextlib", "typing",
                               "math"}, (name, m)
                assert not m.startswith(("portbench.drive", "portbench.run",
                                         "portbench.session")), (name, m)
    import portbench.inputs
    src = open(portbench.inputs.__file__).read()
    assert "federated_pytorch_test_tpu" not in src
