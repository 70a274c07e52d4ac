"""serve_rows_per_block.steady: the real rows of the superblocks the server
dispatched in the window, a block: the difference of its ``serve_block_rows``
counter over that of ``serve_batches``, both read by the ``metrics``
telemetry verb at the window's start and end (program_counter).  Nothing
where the server has no such counter."""


def read(run):
    start, end = run.telemetry.get("start"), run.telemetry.get("end")
    if start is None or end is None:
        return None
    c0, c1 = start.get("counters", {}), end.get("counters", {})
    if "serve_block_rows" not in c1:
        return None
    blocks = c1.get("serve_batches", 0) - c0.get("serve_batches", 0)
    if blocks <= 0:
        return None
    return (c1["serve_block_rows"] - c0.get("serve_block_rows", 0)) / blocks
