"""Model definitions of the port: the dense GQA decoder family
(`zoo.prefill` / `zoo.decode_step`) over nested dicts of tensors."""
