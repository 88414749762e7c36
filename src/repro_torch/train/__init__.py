from repro_torch.train.step import make_train_step, step_grads  # noqa: F401
