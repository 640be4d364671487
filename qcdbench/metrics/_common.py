"""What the metric readers share."""
from qcdbench.bytes_model import PEAKS


def hop_roofline(run, kind: str):
    """The hop's share of its bandwidth roofline (%) in the traced unit: the
    compulsory bytes of every dslash_eo call (qcdbench/bytes_model.py) at the
    card's peak HBM bandwidth, over the device time of the hop's kernels.
    None where the trace has no hop kernels, or where the hop kernels, the
    calls and the launches the port counted (dslash_cuda.counts) are not one
    number: the hop then runs elsewhere."""
    tr = run.get("trace")
    if run["kind"] != kind or not tr or not tr.get("hop_kernels") or run.get("card") not in PEAKS:
        return None
    if not tr["hop_kernels"] == tr["hop_calls"] == tr["hop_launches"]:
        return None
    return 100.0 * tr["hop_bytes"] / PEAKS[run["card"]][0] / tr["hop_device_s"]


def idle_share(run, kind: str):
    """The device's idle share (%) of the traced unit: 1 - busy / window, busy
    the union of every device operation's interval (torch.profiler)."""
    tr = run.get("trace")
    if run["kind"] != kind or not tr or tr.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def per_certified(run, count):
    """The window's seconds over count(unit) summed over the units the
    program certified whole (its every column); None where there are none."""
    n = sum(count(u) for u in run["units"] if u["summary"]["ok"])
    return run["window_s"] / n if n else None
