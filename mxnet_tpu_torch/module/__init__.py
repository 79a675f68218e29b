"""``mx.mod``: the Module API (reference: python/mxnet/module/)."""

from .base_module import BaseModule
from .module import BucketingModule, Module
