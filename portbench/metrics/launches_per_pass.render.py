"""Kernel launches a pass: the profiler's kernel records in the traced
passes that are not the port's own kernels, plus the port's own as their
wrappers counted them over the same passes (the profiler can miss a lone
ctypes launch), over the passes."""


def read(t):
    if t.kind != "pass" or not t.iterations:
        return None
    return (t.other_launches + t.own_launches) / t.iterations
