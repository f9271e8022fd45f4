"""The acting step of the env runners (``policy.act``)."""
