"""CUDA kernels launched per traced proof (torch.profiler)."""


def read(run):
    prof = run.profile
    return None if prof is None or not prof.launches else prof.launches / prof.requests
