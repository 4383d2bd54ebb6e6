"""op_ms: the host time a step spends in the program's ops (each autograd
``Function.forward`` body, or the unordered C2C's ``fft_complex``), their
launches included: the time covered by ``op:*`` spans of
``smfft_tpu_torch.trace``; the mean over the traced window's steps, in
ms."""

from h100bench import spans

start, stop = spans.start, spans.stop


def read(run):
    host = spans.host(run)
    return None if host is None else host["op_ns"] / run.steps / 1e6
