"""Model families of the port: the decoder-only families (``Model``) and
the encoder-decoder family (``EncDecModel``); ``build_model`` picks one."""

from repro_torch.models.model import EncDecModel, Model, build_model  # noqa: F401
