"""The yardstick's counts agree with PERF.md's table of kernels: each
bound there is the larger of bytes over 3.35 TB/s and FLOPs over 989
(bf16) or 67 (f32) TFLOP/s, computed here from the configurations'
shapes."""
import pytest

from benchmark import reference
from benchmark.harness import cell as cellmod
from benchmark.harness import work
from conftest import ROOT

FLAGSHIP = "premetanode10.advtrain.b256"
FLEET = "mnist_metanode64.fleet27.clean"
SERVE = "premetanode10.serve.b256"


def _ops(name, members=None):
    """The cell's ops; ``members`` re-sizes a fleet (the table's member
    rows are of 16 members)."""
    c = cellmod.resolve(name, ROOT)
    if members:
        c.traffic = dict(c.traffic, members=members,
                         member_u=c.traffic["member_u"][:members])
    fam = reference.load(c.config["reference"])
    return c, work.step_ops(fam, c.config, c.traffic)


def _ms(ops, peak):
    return 1e3 * sum(work.least_seconds(work.flops(o), work.nbytes(o), peak)
                     for o in ops)


def _b1_fwd(ops):
    return [o for o in ops if o["kind"] == "conv" and o["k"] == 3
            and o["stride"] == 1 and o["pad"] == 1 and o["phase"] == "fwd"]


def test_peaks_are_the_data_sheets():
    assert work.PEAK_FLOPS == {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
    assert work.PEAK_BYTES_PER_S == 3.35e12


def test_one_b1_call_of_the_flagship():
    _, ops = _ops(FLAGSHIP)
    one = [o for o in _b1_fwd(ops) if o["cin"] == o["cout"] == 64][0]
    assert _ms([one], "bf16") == pytest.approx(0.0201, abs=5e-5)


@pytest.mark.parametrize("name,members,select,calls,bound_ms", [
    (FLAGSHIP, None, "b1_fwd", 136, 2.674),
    (FLAGSHIP, None, "b1_dgrad", 135, 2.664),
    (FLAGSHIP, None, "wgrad", 68, 1.337),
    (FLEET, 16, "b1_fwd", 32, 2.637),
    (FLEET, 16, "b3_fwd", 51, 0.8168),
    (FLEET, 16, "b3_bwd", 51, 1.2251),
    (FLEET, None, "b1_fwd", 32, 2.637 * 27 / 16),
    (FLEET, None, "b3_bwd", 51, 1.2251 * 27 / 16),
])
def test_summed_bounds_of_a_step(name, members, select, calls, bound_ms):
    c, ops = _ops(name, members)
    pick = {
        "b1_fwd": _b1_fwd(ops),
        "b1_dgrad": [o for o in ops if o["kind"] == "conv" and o["k"] == 3
                     and o["stride"] == 1 and o["phase"] == "dgrad"],
        "wgrad": [o for o in ops if o["phase"] == "wgrad"
                  and o["kind"] == "conv" and o["k"] == 3
                  and o["stride"] == 1],
        "b3_fwd": [o for o in ops if o["kind"] == "gn"
                   and o["phase"] == "fwd"],
        "b3_bwd": [o for o in ops if o["phase"] == "gn_bwd"],
    }[select]
    assert len(pick) == calls
    assert _ms(pick, c.config["peak"]) == pytest.approx(bound_ms, rel=5e-4)


def test_b2_both_solves_of_a_request():
    c, ops = _ops(SERVE)
    classes = cellmod.kernel_classes(ROOT)
    least = work.least_ms_by_class(ops, classes, c)
    assert least["b2"] == pytest.approx(1.251, rel=5e-4)
    assert len(work.assign(ops, classes, c)["b1"]) == 4


@pytest.mark.parametrize("name,tflop", [(FLAGSHIP, 6.532), (FLEET, 0.6983 * 27 / 16),
                                        (SERVE, 1.3066)])
def test_model_flops_of_a_unit(name, tflop):
    _, ops = _ops(name)
    assert work.model_flops(ops) / 1e12 == pytest.approx(tflop, rel=1e-3)


@pytest.mark.parametrize("name,owned", [
    (FLAGSHIP, {"b1": 271, "wgrad": 68}),
    (FLEET, {"b1": 64, "wgrad": 32, "b3": 102}),
    (SERVE, {"b1": 4, "b2": 64}),
])
def test_each_class_owns_its_ops(name, owned):
    c, ops = _ops(name)
    got = work.assign(ops, cellmod.kernel_classes(ROOT), c)
    assert {k: len(v) for k, v in got.items()} == owned


@pytest.mark.parametrize("kernel,cls", [
    ("void nodems::conv3x3_igemm_kernel<__nv_bfloat16, 128, 64, 2, 2, 4, "
     "true, 0>(nodems::ConvArgs)", "b1"),
    ("void nodems::conv3x3_halo_kernel<128, 64, 4, 2>(nodems::ConvArgs, int)",
     "b2"),
    ("void nodems::conv3x3_halo_narrow_kernel<64, 4>(nodems::ConvArgs, int)",
     "b1"),
    ("void nodems::conv3x3_f32_kernel<64, 2, 0>(nodems::ConvArgs, "
     "nodems::F32Geom)", "b1"),
    ("void (anonymous namespace)::gelu_rounded_kernel<__nv_bfloat16>("
     "__nv_bfloat16 const*, __nv_bfloat16*, long long)", "b2"),
    ("void nodems::(anonymous namespace)::wgrad_tma_kernel(CUtensorMap, "
     "CUtensorMap, nodems::(anonymous namespace)::TmaWgradArgs)", "wgrad"),
    ("void nodems::gn_act_bwd_kernel<float, 1, true>(float const*)", "b3"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc",
     "library"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::GeluCUDAKernelImpl>(int, float*)", None),
])
def test_kernel_names_go_to_their_class(kernel, cls):
    assert cellmod.classify(kernel, cellmod.kernel_classes(ROOT)) == cls
