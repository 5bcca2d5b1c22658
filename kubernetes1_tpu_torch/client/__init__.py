"""The port's client of the orchestrator's apiserver: its HTTP surface in
the wire form (plain dicts), a list+watch informer over it, and a typed
layer over both.

``errors`` (the Status errors), ``rest`` (``Client`` and a
``ResourceClient`` per resource), ``informer`` (``SharedInformer``,
``InformerFactory``; typed when given a decoder), ``clientset``
(``Clientset``: typed objects, the binding, bulk-binding and eviction
subresources) and ``events`` (``EventRecorder``).  The workloads speak
wire dicts; the port's scheduler speaks typed objects.
"""
