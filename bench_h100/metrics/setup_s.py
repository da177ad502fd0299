"""setup_s: seconds from the start of the process to the window's opening
(imports, CUDA's start, the model's build, the weights, the frames, the
first batch served to build kernels and warm up; host clock)."""


def read(run):
    return run.setup_s
