"""capture_s (driver: util.ChunkGraph): the host seconds of the process's
CUDA graph captures, warm-up runs included (``util.CAPTURES["ns"]``).
The harness captures every width in set-up, so this is a part of
``setup_s``; captures inside the window are the ``captures_in_window``
note."""


def read(ctx):
    try:
        from pygradflow_torch import util
    except ImportError:
        return None
    captures = getattr(util, "CAPTURES", None)
    if captures is None:
        return None
    return captures["ns"] * 1e-9
