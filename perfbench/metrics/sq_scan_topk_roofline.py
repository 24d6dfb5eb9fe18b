"""sq_scan_topk_roofline: percent of the roofline bound in the device time
of what the public wrapper ops.sq_scan_topk launched (kernel K2, the int8
tier's fused scan), over the calls in the profiled part of a traced
window. The work is yardstick.sq_scan_work of each call's own plan."""
from perfbench import yardstick

WRAP = "repro_torch.kernels.ops:sq_scan_topk"


def work(args):
    return yardstick.sq_scan_work(args["queries"], args["valid"],
                                  args["part_ids"], int(args["k_out"]),
                                  args["metric"], args["qsel"])


def read(run):
    return run.roofline("sq_scan_topk_roofline")
