"""lstm_train_roofline.train: the train forward and backward recurrences'
bound time over the device time of these kernels in the traced stretch,
as %."""

from portbench.readers import roofline

KERNELS = ("lstm_step_kernel", "lstm_bwd_step_kernel", "lstm_bwd_last_step_kernel")


def read(run):
    return roofline(run, KERNELS)
