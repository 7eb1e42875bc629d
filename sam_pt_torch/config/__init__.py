from .core import (
    Config,
    compose,
    instantiate,
    load_yaml,
    main,
    resolve_interpolations,
)
