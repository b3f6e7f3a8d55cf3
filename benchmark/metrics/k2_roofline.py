"""K2 (`csrc/in_mean.cu`, FuseNet's instance norm and mean over sources)
in the clip: its bound over its device time, % (layer: kernels)."""

from benchmark import flops, readers


def read(rec):
    sh = rec.get("clip_shape")
    if not sh:
        return None
    return readers.kernel_roofline(
        rec, r"in_mean_kernel|plane_stats_kernel", "instance_norm_mean",
        flops.k2_call(sh["sources"], sh["chunk"], sh["t"], 2 * sh["c"],
                      sh["tail_bytes"]))
