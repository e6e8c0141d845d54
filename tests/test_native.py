"""Native (C++) offline assembly vs the pure-numpy reference path.

The native module (ryujin_tpu/native/assembly.cc) must reproduce the
numpy assembly/packing bit-for-bit up to floating-point summation order.
"""

import numpy as np
import pytest

from ryujin_tpu import native
from ryujin_tpu.offline import assembly, geometry, structured
from ryujin_tpu.offline.mesh import Boundary


def _numpy_variant(fn):
    """Run fn() with the native library disabled."""
    import os

    os.environ["RYUJIN_TPU_NO_NATIVE"] = "1"
    lib, tried = native._LIB, native._TRIED
    try:
        return fn()
    finally:
        del os.environ["RYUJIN_TPU_NO_NATIVE"]
        native._LIB, native._TRIED = lib, tried


@pytest.fixture(scope="module")
def meshes():
    return {
        "step": geometry.step(refinement=0),
        "rect-periodic": geometry.rectangular_domain(
            [0, 0], [1, 1], [3, 3], refinement=2,
            boundary_conditions=[Boundary.periodic] * 4,
        ),
        "annulus": geometry.annulus(refinement=1),
    }


def test_native_lib_builds():
    assert native.get_lib() is not None, "native build failed"


@pytest.mark.parametrize("name", ["step", "rect-periodic", "annulus"])
def test_assemble_matches_numpy(meshes, name):
    mesh = meshes[name]
    d_nat = assembly.assemble(mesh)
    d_np = _numpy_variant(lambda: assembly.assemble(mesh))
    assert (d_nat.indptr == d_np.indptr).all()
    assert (d_nat.indices == d_np.indices).all()
    for f in ("mij", "cij", "mii", "cii", "lumped_mass"):
        np.testing.assert_allclose(
            getattr(d_nat, f), getattr(d_np, f), rtol=0, atol=1e-12,
            err_msg=f,
        )
    assert abs(d_nat.measure_of_omega - d_np.measure_of_omega) < 1e-9


def test_pack_structured_matches_numpy(meshes):
    mesh = meshes["step"]
    data = assembly.assemble(mesh)
    p_nat = structured.pack_structured(data, mesh)
    p_np = _numpy_variant(lambda: structured.pack_structured(data, mesh))
    for f in ("cij", "mij", "mask", "cii", "lumped_mass", "n_nbrs",
              "node_mask"):
        np.testing.assert_allclose(
            getattr(p_nat, f), getattr(p_np, f), rtol=0, atol=1e-14,
            err_msg=f,
        )
    for ra, rb in zip(p_nat.boundary_rounds, p_np.boundary_rounds):
        assert ra.keys() == rb.keys()
        for k in ra:
            assert (ra[k].index == rb[k].index).all()
            np.testing.assert_allclose(ra[k].normal, rb[k].normal,
                                       atol=1e-12)


def test_face_owners_matches_numpy(meshes):
    mesh = meshes["step"]
    c_nat = assembly._face_cell_centers(mesh, mesh.boundary_faces)
    c_np = _numpy_variant(
        lambda: assembly._face_cell_centers(mesh, mesh.boundary_faces)
    )
    np.testing.assert_allclose(c_nat, c_np, atol=0)


def test_library_key_covers_compiler_and_host():
    """A library built on one machine is never loaded on another: the
    cache key changes with the compiler command and the architecture,
    and the build targets the generic instruction set."""
    srcs = [native._HERE / s for s in native._SOURCES]
    base = native._lib_tag(srcs, machine="x86_64")
    assert native._lib_tag(srcs, machine="x86_64") == base
    assert native._lib_tag(srcs, machine="aarch64") != base
    cmd = native._BUILD_CMD + ("-march=native",)
    assert native._lib_tag(srcs, cmd=cmd, machine="x86_64") != base
    assert "-march=native" not in native._BUILD_CMD
