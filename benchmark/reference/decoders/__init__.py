"""One module a decoder type, named as the configuration names it
(``Model.Decoder.type``); each defines ``Decoder(cfg, d_pose, d_model,
operand)``."""
