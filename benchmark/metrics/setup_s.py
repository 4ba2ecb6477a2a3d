"""setup_s (s): from process start to the window's first batch: CUDA
initialisation, building (first run in a checkout) and loading the
kernels, the nominal's cold solve where the mix has one, and the warm-up."""


def read(run):
    return run["setup_s"]
