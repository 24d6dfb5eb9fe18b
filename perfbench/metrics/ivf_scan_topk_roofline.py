"""ivf_scan_topk_roofline: percent of the roofline bound in the device time
of what the public wrapper ops.scan_topk_mqo launched (kernel K1,
ivf_scan_topk, the float32 tier's fused scan), over the calls in the
profiled part of a traced window. The work is yardstick.ivf_scan_work of
each call's own plan."""
from perfbench import yardstick

WRAP = "repro_torch.kernels.ops:scan_topk_mqo"


def work(args):
    return yardstick.ivf_scan_work(args["queries"], args["valid"],
                                   args["part_ids"], int(args["k_out"]),
                                   args["metric"], args["qsel"])


def read(run):
    return run.roofline("ivf_scan_topk_roofline")
