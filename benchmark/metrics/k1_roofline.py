"""K1 (`csrc/transform_warp.cu`, the mean over sources, bf16 out) in the
clip: its bound over its device time, % (layer: kernels)."""

from benchmark import flops, readers


def read(rec):
    sh = rec.get("clip_shape")
    if not sh:
        return None
    return readers.kernel_roofline(
        rec, r"transform_warp_kernel", "transform_warp_pairs_mean",
        flops.k1_call(sh["sources"], sh["chunk"], sh["t"], sh["c"]))
