"""K4 (`csrc/transform_warp_bwd.cu`, seven launches a call): the bound of
its calls over the device time of all seven kernels, % (layer:
kernels)."""

from benchmark import flops, readers

K4_KERNELS = (r"warp_bwd_kernel|da_sort_kernel|da_sum_kernel|"
              r"logits_bwd_kernel|reduce_bwd_kernel|gemm_kernel.*tsnet_sgemm")


def read(rec):
    sh = rec.get("train_shape")
    if not sh:
        return None
    return readers.kernel_roofline(
        rec, K4_KERNELS, "transform_warp_pairs_bwd",
        flops.k4_call(sh["groups"], sh["sources"], sh["t"], sh["c"]))
