"""The zoo's shared refusal of bundled weights."""


def no_pretrained(pretrained: bool) -> None:
    """Raise for ``pretrained=True``: no weights are bundled and nothing
    is downloaded; load a checkpoint with ``set_state_dict``."""
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no model hub egress); "
            "load a checkpoint with set_state_dict")
