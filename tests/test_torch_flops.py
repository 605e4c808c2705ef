"""The port's analytic flop model (slate_tpu_torch.obs.flops) and version
against slate_tpu's, on the CPU: every registered op's op_flops, op_bytes
and serve_flops equal the reference's on the same shapes (exact float
equality: the same arithmetic), the peak table holds the H100 alone, and
off the card the peak and MFU are None.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import importlib

import pytest

from slate_tpu.obs import flops as ref_flops

from slate_tpu_torch.obs import flops

# the packages export a version() function under the module's name
ref_version = importlib.import_module("slate_tpu.version")
version = importlib.import_module("slate_tpu_torch.version")

SHAPES = [
    [(64, 48), (48, 32)],
    [(300, 300), (300, 7)],
    [(1000, 40)],
    [(17,)],
    [(8, 96, 64), (8, 96, 3)],
    [(5, 128, 32)],
    [],
]


def test_every_registered_model_matches_the_reference():
    assert flops.registered_ops() == ref_flops.registered_ops()
    for op in sorted(flops.registered_ops()):
        for shapes in SHAPES:
            assert flops.op_flops(op, shapes) == ref_flops.op_flops(
                op, shapes), (op, shapes)
            for dtype in ("float32", "bfloat16", "complex128", None):
                assert flops.op_bytes(op, shapes, dtype) == \
                    ref_flops.op_bytes(op, shapes, dtype), (op, shapes)
        for sizes in ([96, 40, 0], [1]):
            s = [(len(sizes), 96, 64)]
            assert flops.op_flops(op, s, sizes) == ref_flops.op_flops(
                op, s, sizes)
    assert flops.op_flops("nope", [(4, 4)]) is None
    assert flops.op_bytes("nope", [(4, 4)], "float32") is None


@pytest.mark.parametrize("op", ["solve", "chol_solve",
                                "least_squares_solve", "unknown"])
def test_serve_flops_matches_the_reference(op):
    problems = [((96, 96), (96, 16)), ((200, 100), (200, 16)),
                ((4000, 4000), (4000, 16))]
    assert flops.serve_flops(op, problems) == ref_flops.serve_flops(
        op, problems)


def test_peak_table_and_off_card_behaviour():
    """One card in the table (the H100: f32 on the CUDA cores, since the
    port forbids TF32; bf16 dense on the tensor cores; 3.35 TB/s); off
    the card no peak, no bandwidth and no MFU; an override pins every
    dtype, and the byte rate math is the reference's."""
    assert [k for k, _ in flops.PEAK_TABLE] == ["h100"]
    assert flops.PEAK_TABLE[0][1] == {"bfloat16": 989e12, "float32": 67e12}
    assert flops.BANDWIDTH_TABLE == (("h100", 3.35e12),)
    assert flops.chip_peak("float32") == (None, "cpu")
    assert flops.chip_bandwidth() == (None, "cpu")
    assert flops.peak() is None and flops.peak("float32") is None
    assert flops.mfu(1e12, 1.0, "float32") is None
    with flops.peak_override(1e12):
        assert flops.peak("float64") == 1e12
        assert flops.mfu(5e11, 1.0) == 0.5
    assert flops.peak() is None
    assert flops.achieved_gbps(3e9, 2.0) == ref_flops.achieved_gbps(3e9,
                                                                    2.0)
    assert flops.achieved_gbps(None, 1.0) is None


def test_split_product_bound_reads_the_tf32_rate():
    """The 3xTF32 product's bound is three passes at the H100's dense TF32
    rate (its own table entry); the f32 peak every mfu reads is still the
    CUDA cores' 67 TFLOP/s; off the card, and for a card the table lacks,
    there is no bound."""
    assert flops.TF32_TABLE == (("h100", 494.7e12),)
    work = 2.0 * 10240 * 10240 * 256
    assert flops.split_product_seconds(
        work, kind="NVIDIA H100 80GB HBM3") == 3 * work / 494.7e12
    assert dict(flops.PEAK_TABLE)["h100"]["float32"] == 67e12
    assert flops.split_product_seconds(work) is None
    assert flops.split_product_seconds(work, kind="some other card") is None


def test_version():
    assert version.__version__ == ref_version.__version__
    assert version.version() == ref_version.version()
    assert version.id() == f"slate_tpu_torch {version.__version__}"
