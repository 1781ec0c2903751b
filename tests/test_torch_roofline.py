"""The port's roofline against the reference's, on the CPU.

``_wire_multiplier`` and the three ``*_model_flops`` equal the
reference's on the same inputs; collective records give the
``CollectiveStats`` the reference's parser reads from the compiled
program's text for the same five ops (``tests/test_system.py``'s); and
``analyze`` picks the reference's bottleneck and useful ratio, with its
terms at the H100's data-sheet peaks (989 TFLOP/s bf16, 3.35 TB/s HBM, one
NVLink 4 link at 25 GB/s a direction).
"""

import pytest

from repro.launch import roofline as jroofline

from repro_torch.launch import roofline

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")


@pytest.mark.parametrize("op", OPS)
def test_wire_multiplier_equals_the_reference(op):
    for n in (0, 1, 2, 4, 16, 512):
        assert roofline._wire_multiplier(op, n) == \
            jroofline._wire_multiplier(op, n)


HLO = """
  %ag = bf16[8,128]{1,0} all-gather(%x), replica_groups=[2,16]<=[32]
  %ar = f32[256]{0} all-reduce(%y), replica_groups={{0,1,2,3}}
  %cp = bf16[64,64]{1,0} collective-permute(%z)
  %rs = f32[16]{0} reduce-scatter(%w), replica_groups=[2,4]<=[8]
  %done = f32[256]{0} all-reduce-done(%ar)
"""
# the same ops as records: (op, result bytes, group; None takes the default)
RECORDS = [("all-gather", 8 * 128 * 2, 16), ("all-reduce", 256 * 4, 4),
           ("collective-permute", 64 * 64 * 2, None),
           ("reduce-scatter", 16 * 4, 4)]


def test_records_give_the_reference_parsers_stats():
    want = jroofline.collective_bytes(HLO, default_group=16)
    got = roofline.collective_bytes(RECORDS, default_group=16)
    assert got.by_op == want.by_op
    assert got.count == want.count == 4
    assert got.total_wire_bytes == pytest.approx(want.total_wire_bytes,
                                                 rel=1e-15)
    with pytest.raises(ValueError, match="unknown collective"):
        roofline.collective_bytes([("broadcast", 8, 4)], default_group=4)


def test_constants_are_the_h100_data_sheets():
    assert roofline.PEAK_BF16_TFLOPS == 989.0
    assert roofline.HBM_GBPS == 3350.0
    assert roofline.NVLINK_LINK_GBPS == 25.0


@pytest.mark.parametrize("flops,hbm,records,chips,mflops", [
    (1e12, 1e9, [], 256, 2.56e14),                      # compute
    (1e9, 1e12, [], 16, 3e10),                           # memory
    (1e9, 1e6, [("all-reduce", 1 << 30, 16)], 16, 1e10),  # collective
    (0.0, 0.0, [], 8, 1e9),                               # nothing counted
])
def test_analyze_equals_the_reference(flops, hbm, records, chips, mflops):
    hlo = "\n".join(f"  %c = s8[{rb}]{{0}} {op}(%x), "
                    f"replica_groups={{{{{','.join(map(str, range(n)))}}}}}"
                    for op, rb, n in records)
    want = jroofline.analyze("a", "s", "m", chips,
                             {"flops": flops, "bytes accessed": hbm}, hlo,
                             model_flops=mflops, memory_bytes=2**30,
                             default_group=16, links=2, note="n")
    got = roofline.analyze("a", "s", "m", chips,
                           {"flops": flops, "bytes accessed": hbm}, records,
                           model_flops=mflops, memory_bytes=2**30,
                           default_group=16, links=2, note="n")
    assert got.bottleneck == want.bottleneck
    assert got.useful_flops_ratio == want.useful_flops_ratio
    assert got.wire_bytes == want.wire_bytes
    assert got.collective_by_op == want.collective_by_op
    assert got.compute_s == flops / 989e12
    assert got.memory_s == hbm / 3350e9
    assert got.collective_s == got.wire_bytes / (2 * 25e9)
    assert got.to_dict().keys() == want.to_dict().keys()
    assert got.memory_per_device_gb == want.memory_per_device_gb == 1.0


@pytest.mark.parametrize("n,tokens", [(8.0e9, 1 << 20), (3.6e8, 4096),
                                      (1.2e12, 3)])
def test_model_flops_equal_the_reference(n, tokens):
    assert roofline.train_model_flops(n, tokens) == \
        jroofline.train_model_flops(n, tokens)
    assert roofline.prefill_model_flops(n, tokens) == \
        jroofline.prefill_model_flops(n, tokens)
    assert roofline.decode_model_flops(n, tokens) == \
        jroofline.decode_model_flops(n, tokens)


def test_roofline_terms_name_the_largest():
    terms, b = roofline.roofline_terms(989e12, 0.0, 0.0)
    assert (terms["compute"], b) == (1.0, "compute")
    terms, b = roofline.roofline_terms(0.0, 3350e9 * 2, 25e9, links=1)
    assert terms == {"compute": 0.0, "memory": 2.0, "collective": 1.0}
    assert b == "memory"
