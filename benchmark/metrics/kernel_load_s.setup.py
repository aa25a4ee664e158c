"""Set-up time the kernels' library takes to load: the program's
``setup.kernel_load`` span (the sources' digest and the dlopen) less the
``setup.kernel_build`` span inside it (nvcc, which runs only in a
checkout's first run), s."""

from benchmark import spans


def read(r):
    found = spans.of(r)[0]
    builds = {sp.parent: sp.end_us - sp.start_us for sp in found if sp.name == "setup.kernel_build"}
    loads = [sp.end_us - sp.start_us - builds.get(sp.id, 0.0) for sp in found if sp.name == "setup.kernel_load"]
    return sum(loads) * 1e-6 if loads else None
