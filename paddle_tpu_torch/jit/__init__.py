"""paddle_tpu_torch.jit (counterpart of paddle_tpu/jit): the exported
program artifact (`save`, `load`, `TranslatedLayer`) and its bucket
programs (`aot`).

`to_static` and the rest of the reference's `jit/api.py` and
`dy2static.py` (whole-program tracing of training and eval steps) are not
ported yet: they raise `NotImplementedError` naming ROADMAP Queue 1 item 8.
"""
from .aot import CompileCache, compile_batched
from .save_load import TranslatedLayer, load, save

__all__ = ["save", "load", "TranslatedLayer", "CompileCache",
           "compile_batched", "to_static", "not_to_static", "ignore_module",
           "enable_to_static", "set_code_level", "set_verbosity",
           "StaticFunction", "TO_STATIC_ITEM"]

#: where `to_static` comes in
TO_STATIC_ITEM = ("ROADMAP Queue 1 item 8 (the rest of the surface: "
                  "jit/static)")


def _unported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"paddle_tpu_torch.jit.{name} is not ported yet; it comes with "
            f"{TO_STATIC_ITEM}")

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = f"Not ported yet: comes with {TO_STATIC_ITEM}."
    return fn


to_static = _unported("to_static")
not_to_static = _unported("not_to_static")
ignore_module = _unported("ignore_module")
enable_to_static = _unported("enable_to_static")
set_code_level = _unported("set_code_level")
set_verbosity = _unported("set_verbosity")
StaticFunction = _unported("StaticFunction")
