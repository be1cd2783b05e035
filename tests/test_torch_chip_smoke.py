"""``chip_smoke.py``'s report of what ptxas made of each kernel, on the CPU:
the lines below are ``nvcc -Xptxas -v`` output for the port's kernels as the
build log holds them (one instance with a spill, as a build of the factors
kernel once had, and the cluster histogram kernel)."""
import pytest

import chip_smoke

LOG = """\
ptxas info    : Function properties for _ZN51_GLOBAL__N__a1e2ad33_18_vecchia_factors_cu_vf_max_m15nll_grad_kernelILi8EEEvPKfS2_PKiS2_S2_S2_S2_Pfiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 162 registers, used 1 barriers
ptxas info    : Function properties for _ZN51_GLOBAL__N__a1e2ad33_18_vecchia_factors_cu_vf_max_m14factors_kernelILi8EEEvPKfS2_PKiS2_PfS5_iiiiii
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Function properties for _ZN51_GLOBAL__N__a1e2ad33_18_vecchia_factors_cu_vf_max_m14factors_kernelILi4EEEvPKfS2_PKiS2_PfS5_iiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers
ptxas info    : Function properties for _ZN51_GLOBAL__N__a1e2ad33_18_vecchia_factors_cu_vf_max_m14factors_kernelILi2EEEvPKfS2_PKiS2_PfS5_iiiiii
    24 bytes stack frame, 36 bytes spill stores, 64 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Function properties for _ZN45_GLOBAL__N__ab0b9da9_12_histogram_cu_04b00a9a11hist_kernelEPKhPKfS3_S1_Pfiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 47 registers, used 1 barriers, 24576 bytes smem
"""


@pytest.mark.parametrize("kernel,want", [
    ("factors_kernel", [("factors_kernel<8>", 8, 8, 8, 56),
                        ("factors_kernel<4>", 0, 0, 0, 56),
                        ("factors_kernel<2>", 24, 36, 64, 40)]),
    ("nll_grad_kernel", [("nll_grad_kernel<8>", 0, 0, 0, 162)]),
    ("hist_kernel", [("hist_kernel", 0, 0, 0, 47)]),
])
def test_ptxas_report_reads_every_instance(kernel, want):
    got = chip_smoke.ptxas_report(LOG, kernel)
    assert [(x["instance"], x["stack_frame_bytes"], x["spill_store_bytes"],
             x["spill_load_bytes"], x["registers"]) for x in got] == want


def test_ptxas_report_of_a_kernel_not_built_is_empty():
    assert chip_smoke.ptxas_report(LOG, "count_to_float_kernel") == []
    assert chip_smoke.ptxas_report("", "factors_kernel") == []


def test_hist_bound_counts_only_the_rows_in_the_mask():
    full, by = chip_smoke.hist_bound(100_000, 100_000, 5, 254)
    small, _ = chip_smoke.hist_bound(100_000, 3_000, 5, 254)
    assert by == "bytes"
    nbytes = 100_000 + 100_000 * (4 + 4 + 5) + 5 * 254 * 12
    assert full == pytest.approx(nbytes / chip_smoke.H100_BYTES_PER_S * 1e3)
    assert small < full
