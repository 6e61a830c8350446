"""One module a model type, named as the configuration names it
(``Model.type``); each defines ``attach(model, d_model)``, which adds the
type's parameters, and ``memory(model, low, mid, high)``, which joins the
speech encoder's streams into the memory."""
