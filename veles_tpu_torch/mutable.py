"""Shared mutable values used for control flow between units.

Counterpart of ``veles_tpu/mutable.py``, pure Python, kept as a copy so
the port imports nothing of the JAX package.

``Bool`` is a shared, mutable boolean cell.  Units hold references to the
same cell so that one unit flipping a flag is instantly visible to every
gate that tests it.  Boolean operators (``|``, ``&``, ``~``, ``^``) build
*derived* cells that recompute from their operands on read, which is how
gate expressions like ``decision.complete | loader.train_ended`` stay live.

``LinkableAttribute`` aliases an attribute of one object to an attribute of
another (one- or two-way), which is how ``unit.link_attrs`` shares tensors
and scalars across the graph without copying.
"""

__all__ = ["Bool", "LinkableAttribute"]


def _op_or(a, b):
    return bool(a) or bool(b)


def _op_and(a, b):
    return bool(a) and bool(b)


def _op_xor(a, b):
    return bool(a) != bool(b)


def _op_not(a):
    return not bool(a)


#: named expression ops: picklable (unlike lambdas), so derived gate
#: expressions stay LIVE across snapshot/restore
_BOOL_OPS = {"or": _op_or, "and": _op_and, "xor": _op_xor, "not": _op_not}


class Bool(object):
    """A mutable boolean cell supporting live derived expressions."""

    __slots__ = ("_value", "_op", "_args", "on_change")

    def __init__(self, value=False):
        self._op = None
        self._args = ()
        self._value = bool(value)
        self.on_change = None

    # -- value access ------------------------------------------------------

    def __bool__(self):
        if self._op is not None:
            return _BOOL_OPS[self._op](*self._args)
        return self._value

    __nonzero__ = __bool__

    @property
    def derived(self):
        return self._op is not None

    def __ilshift__(self, value):
        """``flag <<= True`` assigns; assignment breaks derivation."""
        self._op = None
        self._args = ()
        new = bool(value)
        changed = new != self._value
        self._value = new
        if changed and self.on_change is not None:
            self.on_change(self)
        return self

    # -- derivation --------------------------------------------------------

    @staticmethod
    def _derived(op, *args):
        b = Bool()
        b._op = op
        b._args = args
        return b

    def __or__(self, other):
        return Bool._derived("or", self, _as_bool(other))

    __ror__ = __or__

    def __and__(self, other):
        return Bool._derived("and", self, _as_bool(other))

    __rand__ = __and__

    def __xor__(self, other):
        return Bool._derived("xor", self, _as_bool(other))

    __rxor__ = __xor__

    def __invert__(self):
        return Bool._derived("not", self)

    def __repr__(self):
        kind = "derived" if self.derived else "plain"
        return "<Bool %s %s>" % (kind, bool(self))

    # Both plain and derived cells round-trip: the op name + operand
    # Bools pickle fine, and pickle preserves shared-object identity so
    # a gate expression still tracks the SAME source cells after
    # restore (the reference's gate-remembering semantics).
    def __getstate__(self):
        return {"value": self._value, "op": self._op, "args": self._args}

    def __setstate__(self, state):
        self._op = state.get("op")
        self._args = state.get("args", ())
        self._value = state["value"]
        self.on_change = None


def _as_bool(value):
    if isinstance(value, Bool):
        return value
    return Bool(bool(value))


class LinkableAttribute(object):
    """Alias ``obj.name`` to ``source_obj.source_name``.

    Installed as a class-level descriptor with per-instance targets, so
    several instances of the same class can link to different sources.
    Assignment through a one-way link raises unless ``assignment_guard`` is
    disabled; two-way links propagate writes back to the source.
    """

    #: name of the per-instance link table.  Deliberately has no trailing
    #: underscore: links between units pickle together with the workflow
    #: graph (matching the reference, which pickles links too), so data
    #: aliases survive snapshot/restore.
    TABLE = "_linked_attrs"

    @classmethod
    def reinstall(cls, obj):
        """Ensure class-level descriptors exist for every pickled link.

        A snapshot restored in a FRESH process carries the
        per-instance link table, but the descriptors were installed on
        the original process's class object — without this, restored
        units lose every data alias and re-initialize fails on
        unsatisfied demands."""
        table = obj.__dict__.get(cls.TABLE)
        if not table:
            return
        klass = type(obj)
        for name in table:
            if not isinstance(klass.__dict__.get(name),
                              _LinkDescriptor):
                setattr(klass, name, _LinkDescriptor(name))
            # a plain instance attribute would shadow the descriptor
            obj.__dict__.pop(name, None)

    def __init__(self, obj, name, source_obj, source_name,
                 two_way=False, assignment_guard=True):
        self.name = name
        self.two_way = two_way
        self.assignment_guard = assignment_guard
        cls = type(obj)
        descriptor = cls.__dict__.get(name)
        if not isinstance(descriptor, _LinkDescriptor):
            descriptor = _LinkDescriptor(name)
            # Remove any plain instance attribute that would shadow us.
            setattr(cls, name, descriptor)
        obj.__dict__.pop(name, None)
        table = obj.__dict__.setdefault(LinkableAttribute.TABLE, {})
        table[name] = (source_obj, source_name, two_way, assignment_guard)

    @staticmethod
    def unlink(obj, name):
        """Remove the alias; the attribute becomes a plain instance attr."""
        table = obj.__dict__.get(LinkableAttribute.TABLE)
        if table is not None:
            table.pop(name, None)


class _LinkDescriptor(object):
    """Class-level descriptor reading per-instance link targets from the
    instance's own ``_linked_attrs`` table (no global id-keyed state, so
    no leaks, no id-reuse aliasing, and pickling just works)."""

    def __init__(self, name):
        self.name = name

    def _target(self, obj):
        table = obj.__dict__.get(LinkableAttribute.TABLE)
        if table is None:
            return None
        return table.get(self.name)

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        target = self._target(obj)
        if target is None:
            try:
                return obj.__dict__[self.name]
            except KeyError:
                raise AttributeError(self.name)
        source_obj, source_name, _, _ = target
        return getattr(source_obj, source_name)

    def __set__(self, obj, value):
        target = self._target(obj)
        if target is None:
            obj.__dict__[self.name] = value
            return
        source_obj, source_name, two_way, guard = target
        if two_way or not guard:
            setattr(source_obj, source_name, value)
        else:
            raise AttributeError(
                "%s.%s is linked one-way from %s.%s; breaking the link by "
                "assignment is forbidden" %
                (type(obj).__name__, self.name,
                 type(source_obj).__name__, source_name))

    def __delete__(self, obj):
        table = obj.__dict__.get(LinkableAttribute.TABLE)
        if table is not None:
            table.pop(self.name, None)
