from .engine import Engine, Request, ServeConfig
from .router import (ROUTER_POLICIES, RandomRouter, Replica, RoundRobinRouter,
                     Router, ShapeAffinityRouter, make_router, plan_coverage)

__all__ = ["Engine", "Request", "ServeConfig", "ROUTER_POLICIES",
           "RandomRouter", "Replica", "RoundRobinRouter", "Router",
           "ShapeAffinityRouter", "make_router", "plan_coverage"]
