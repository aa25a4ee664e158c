"""95th percentile of the host wall of one ``api.decode`` in the window, from the host array
handed in to the parsed result returned, ms."""

import numpy as np


def read(r):
    return float(np.percentile(r.latencies_ms, 95)) if r.latencies_ms else None
