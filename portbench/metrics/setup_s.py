"""Set-up: process start to the window's start (imports, the kernel
build or its cache, weights drawn on the device, the program built, the
cell's shapes warmed)."""


def read(record):
    return record["setup_s"]
