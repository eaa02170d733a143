"""Shared by the decode rooflines and the serving mfus."""
from port_bench import work


def decode_roofline(run):
    """Least time of every request's ``vgm_decode_table`` launch (its
    bucket's rows of the table's continuous columns) over the device time
    of the kernel's launches in the traced window; nothing when the
    launches and the answered requests do not pair up."""
    if run["kind"] != "serve":
        return None
    ns, n = run["trace"].device_ns("vgm_decode_table_kernel")
    done = [r for r in run["traced"]["requests"] if r["bucket"] is not None]
    if not n or n != len(done):
        return None
    least = sum(work.least_seconds(*work.vgm_decode_table(
        r["bucket"], run["n_cont"], run["kmax"])) for r in done)
    return 100.0 * least / (ns / 1e9)


def serve_mfu(run):
    """The generator forwards' FLOPs of the traced window's answered
    requests (at their bucket's rows) over the card's busy time in that
    window times the float32 peak."""
    busy = run["trace"].busy_s
    if run["kind"] != "serve" or not busy:
        return None
    c = run["config"]
    flops = sum(work.ctgan_generator_flops(
        z_dim=c["z_dim"], gen_hidden=c["gen_hidden"], rows=r["bucket"],
        data_dim=run["dim"], cond_dim=run["cond_dim"])
        for r in run["traced"]["requests"] if r["bucket"] is not None)
    return 100.0 * flops / (busy * work.PEAK_F32_FLOPS)
