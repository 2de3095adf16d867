"""setup_s: seconds from the process's start to the window's: importing,
making the weights on the device, loading (on a first run in a checkout,
building) the kernels, and warming up the cell's shapes."""


def read(run):
    return run.setup_s
