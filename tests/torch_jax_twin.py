"""The JAX twin of a port net for the parity tests: the port's net is
initialised from a seed and run once (which fixes its deferred shapes),
and the JAX package's net of the same make takes its values through
``Parameter._load_init``, as the JAX package's ``load_parameters`` does.
So the reference's weights cost one host-to-device copy each instead of
an initialiser run operator by operator (each shape compiled on its own),
and the two nets hold the same numbers by construction.
"""

import numpy as np
import torch

from mxnet_tpu import nd

from mxnet_tpu_torch import convert
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.context import cpu


def strip(net):
    """Parameter shapes by name without the net's prefix."""
    return {k[len(net.prefix):]: tuple(p.shape)
            for k, p in net.collect_params().items()}


def values(net):
    """Parameter values (numpy) by name without the net's prefix."""
    return {k[len(net.prefix):]: p.data().asnumpy()
            for k, p in net.collect_params().items()}


def port_net(make, x, seed, init=None):
    """The port's net of ``make``: ``init`` (Xavier by default) from a
    torch generator seeded with ``seed``, then a forward of ``x[:1]``
    (a numpy batch) to complete the deferred shapes."""
    with cpu():
        net = make()
        net.initialize(init=init or tinit.Xavier(),
                       generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            net(torch.from_numpy(x[:1]))
    return net


def draw_norm_stats(params, seed):
    """Random BatchNorm scales, shifts and running statistics (positive
    variances) in ``params`` (a dict of numpy arrays, changed in place),
    so every parameter matters and predict mode is not the identity."""
    rng = np.random.RandomState(seed)
    for name in params:
        if name.endswith(("gamma", "running_var")):
            params[name] = rng.uniform(0.5, 1.5, params[name].shape) \
                .astype(np.float32)
        elif name.endswith(("beta", "running_mean")):
            params[name] = rng.uniform(-0.2, 0.2, params[name].shape) \
                .astype(np.float32)
    return params


def load_jax(jnet, params, grads=True):
    """Give every parameter of the JAX ``jnet`` its value from ``params``
    (names without the prefix).  ``grads=False`` sets ``grad_req`` to
    ``null`` first, for a net that only runs forward."""
    for name, p in jnet.collect_params().items():
        if not grads:
            p.grad_req = "null"
        p._load_init(nd.array(params[name[len(jnet.prefix):]]))
    return jnet


def load_port(tnet, params):
    """Give the port's ``tnet`` the values of ``params`` (names without
    the prefix)."""
    convert.load_gluon_params(tnet, params)
    return tnet
