"""K3-flow (`csrc/transform_warp.cu`, the train step's warp forward with
its flow): its bound over its device time, % (layer: kernels)."""

from benchmark import flops, readers


def read(rec):
    sh = rec.get("train_shape")
    if not sh:
        return None
    return readers.kernel_roofline(
        rec, r"transform_warp_kernel", "transform_warp_pairs",
        flops.k3flow_call(sh["groups"], sh["sources"], sh["t"], sh["c"]))
