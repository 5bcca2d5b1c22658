"""The port's client of the orchestrator's apiserver: its HTTP surface in
the wire form (plain dicts), and a list+watch informer over it.

``errors`` (the Status errors), ``rest`` (``Client`` and a
``ResourceClient`` per resource) and ``informer`` (``SharedInformer``,
``InformerFactory``).  A client, not control plane: the apiserver,
scheduler, controllers and kubelet stay the JAX package's, run as their
own processes.
"""
