"""Lazily computed, resettable result attributes.

Counterpart of :mod:`geomloss_tpu.utils.cache` (plain Python). Result
objects (:class:`~geomloss_tpu_torch.ot.result.OTResult` and friends)
expose expensive quantities — ``plan``, ``value``, ``marginal_a``... —
that are computed at most once per instance. Classes list the public
names in ``_cached_properties`` and implement each as a private
``_name()`` method; the :func:`lazy_properties` class decorator installs
the matching read-only properties.
"""

__all__ = ["lazy_properties", "add_cached_methods_to_sphinx"]

_CACHE_ATTR = "_lazy_cache"


def _make_property(name):
    impl_name = "_" + name

    def getter(self):
        cache = self.__dict__.setdefault(_CACHE_ATTR, {})
        if name not in cache:
            # Resolve the implementation on the class: result constructors
            # also stash raw inputs under the same "_name" slots, which
            # must not shadow the compute methods.
            cache[name] = getattr(type(self), impl_name)(self)
        return cache[name]

    getter.__name__ = name
    return property(getter, doc=None)


def lazy_properties(cls):
    """Class decorator: for every ``name`` in ``cls._cached_properties``,
    expose a read-only property backed by ``cls._name()`` whose result is
    cached per instance. Adds a ``cache_clear()`` method that drops every
    cached value (e.g. after in-place potential updates)."""
    for name in getattr(cls, "_cached_properties", ()):
        prop = _make_property(name)
        prop.fget.__doc__ = getattr(cls, "_" + name).__doc__
        setattr(cls, name, prop)

    def cache_clear(self):
        """Forget every lazily computed attribute of this instance."""
        self.__dict__.pop(_CACHE_ATTR, None)

    cls.cache_clear = cache_clear
    return cls


#: Alias of :func:`lazy_properties`, under the JAX package's older name.
add_cached_methods_to_sphinx = lazy_properties
