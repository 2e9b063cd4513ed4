"""The port's tokenizer sidecar against the JAX package's.

Held exactly: every message class's bytes on seeded values and each
package decoding the other's; each package's ``UdsTokenizerClient``
against the other's server over a Unix socket (ids, offsets, rendered
text, multimodal placeholders and content-addressed hashes, tools, the
adversarial marker, the score-path features, a model that fails to load);
the ``tokenization.TokenizationService`` protobuf wire on both servers;
the retry policy on a dead socket and on the ``services.tokenizer.rpc``
failpoint; the tokenization pool and prompt scorer, which record the
tokenization latency; and the port's protobuf stub against JAX's.

The backends are ``SimpleTokenizer``, the HF backend on the vendored tiny
tokenizer (``tests/assets/tiny_hf_tokenizer``: a BPE vocabulary and a
ChatML-style Jinja template with tools and multimodal parts; importing
``transformers`` takes most of this file's time) and, for a model that
fails to load, a registry whose loader raises.
"""

import importlib
import json
import pathlib

import grpc
import numpy as np
import pytest

from llmd_kv_cache_tpu.core import TokenProcessorConfig as JaxTokensConfig
from llmd_kv_cache_tpu.index import InMemoryIndex as JaxInMemoryIndex
from llmd_kv_cache_tpu.scoring import Indexer as JaxIndexer
from llmd_kv_cache_tpu.scoring import IndexerConfig as JaxIndexerConfig
from llmd_kv_cache_tpu.services.tokenizer import backends as jax_backends
from llmd_kv_cache_tpu.services.tokenizer import client as jax_client
from llmd_kv_cache_tpu.services.tokenizer import messages as jax_msgs
from llmd_kv_cache_tpu.services.tokenizer import pool as jax_pool
from llmd_kv_cache_tpu.services.tokenizer import service as jax_service
from llmd_kv_cache_tpu.services.tokenizerpb import tokenizer_pb2 as jax_pb
from llmd_kv_cache_tpu_torch.core.token_processor import TokenProcessorConfig
from llmd_kv_cache_tpu_torch.index.in_memory import InMemoryIndex
from llmd_kv_cache_tpu_torch.metrics import collector as port_collector
from llmd_kv_cache_tpu_torch.resilience.policy import RetryPolicy
from llmd_kv_cache_tpu_torch.scoring.indexer import Indexer, IndexerConfig
from llmd_kv_cache_tpu_torch.services.tokenizer import backends as port_backends
from llmd_kv_cache_tpu_torch.services.tokenizer import client as port_client
from llmd_kv_cache_tpu_torch.services.tokenizer import messages as port_msgs
from llmd_kv_cache_tpu_torch.services.tokenizer import pool as port_pool
from llmd_kv_cache_tpu_torch.services.tokenizer import service as port_service
from llmd_kv_cache_tpu_torch.services.tokenizerpb import tokenizer_pb2 as port_pb
from torch_telemetry_helpers import private_flight_recorders, private_jax_metrics

PKGS = ("jax", "port")
MSGS = {"jax": jax_msgs, "port": port_msgs}
CLIENT = {"jax": jax_client, "port": port_client}
SERVICE = {"jax": jax_service, "port": port_service}
BACKENDS = {"jax": jax_backends, "port": port_backends}
POOL = {"jax": jax_pool, "port": port_pool}
FAILPOINTS = {pkg: importlib.import_module(f"{name}.resilience.failpoints") for pkg, name in
              (("jax", "llmd_kv_cache_tpu"), ("port", "llmd_kv_cache_tpu_torch"))}
BLOCK = 4
HF_MODEL = str(pathlib.Path(__file__).parent / "assets" / "tiny_hf_tokenizer")


@pytest.fixture(autouse=True, scope="module")
def _private_globals():
    """JAX's metric families (the pool records tokenization latency) and
    both flight recorders of this module's own."""
    with pytest.MonkeyPatch.context() as mp, private_flight_recorders():
        private_jax_metrics(mp)
        yield


def failing_registry(pkg):
    """A registry whose loader raises for the model ``missing`` (a model
    that fails to load, without ``transformers``)."""
    base = BACKENDS[pkg].TokenizerRegistry

    class Failing(base):
        @staticmethod
        def _load(model_name):
            if model_name == "missing":
                raise OSError("no tokenizer files for 'missing'")
            return base._load(model_name)

    return Failing()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    out = {}
    for pkg in PKGS:
        sock = str(tmp_path_factory.mktemp(f"tok-{pkg}") / "tok.sock")
        svc = SERVICE[pkg].TokenizerService(failing_registry(pkg))
        out[pkg] = {"sock": sock, "server": SERVICE[pkg].serve_uds(sock, svc)}
    yield out
    for pkg in PKGS:
        out[pkg]["server"].stop(grace=None)


@pytest.fixture(scope="module")
def clients(servers):
    """(client package, server package) -> a client."""
    out = {(c, s): CLIENT[c].UdsTokenizerClient(servers[s]["sock"], timeout_s=10.0)
           for c in PKGS for s in PKGS}
    yield out
    for client in out.values():
        client.close()


# --------------------------------------------------------------------------
# message bytes
# --------------------------------------------------------------------------

def seeded_messages(mod, seed):
    rng = np.random.default_rng(seed)
    ids = [int(t) for t in rng.integers(0, 2**31, int(rng.integers(0, 30)))]
    offsets = [(int(a), int(a) + int(b)) for a, b in rng.integers(0, 300, (len(ids), 2))]
    text = " ".join(f"w{int(x)}" for x in rng.integers(0, 99, 6)) + " é ☃"
    hashes = {"image": [f"{int(x):064x}" for x in rng.integers(0, 2**62, 2)]}
    ranges = {"image": [(int(rng.integers(0, 50)), int(rng.integers(1, 9)))]}
    msgs = [mod.ChatMessage("system", "be brief"),
            mod.ChatMessage("user", [{"type": "text", "text": text},
                                     {"type": "image_url", "image_url": {"url": "http://x/a"}}]),
            mod.ChatMessage("assistant", "", tool_calls=[{"function": {"name": "f"}}])]
    return [
        mod.InitializeTokenizerRequest(model_name=f"m{seed}"),
        mod.InitializeTokenizerResponse(success=bool(seed % 2), error="" if seed % 2 else "e"),
        mod.TokenizeRequest(model_name="simple", text=text, add_special_tokens=bool(seed % 2),
                            return_offsets=True),
        mod.TokenizeResponse(token_ids=ids, offsets=offsets, error=""),
        mod.RenderChatRequest(model_name="simple", messages=msgs,
                              chat_template=None if seed % 2 else "{{ x }}",
                              add_generation_prompt=bool(seed % 2),
                              tools=[{"name": "search", "n": seed}] if seed else None,
                              template_kwargs={"documents": [{"t": seed}]} if seed else {}),
        mod.RenderChatResponse(token_ids=ids, rendered_text=text, mm_hashes=hashes,
                               mm_placeholders=ranges, error=""),
        mod.RenderCompletionRequest(model_name="simple", prompt=text,
                                    add_special_tokens=not seed % 2),
    ]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", range(7), ids=[
    "init_req", "init_resp", "tokenize_req", "tokenize_resp", "chat_req", "chat_resp",
    "completion_req"])
def test_message_bytes_equal_and_cross_decode(seed, kind):
    ref, ours = seeded_messages(jax_msgs, seed)[kind], seeded_messages(port_msgs, seed)[kind]
    assert ours.to_bytes() == ref.to_bytes()
    plain = lambda obj: json.loads(json.dumps(obj, default=vars))  # noqa: E731
    assert plain(type(ours).from_bytes(ref.to_bytes())) == plain(ref)
    assert plain(type(ref).from_bytes(ours.to_bytes())) == plain(ours)


# --------------------------------------------------------------------------
# both packages' clients on both servers
# --------------------------------------------------------------------------

def chat(mod, *parts, role="user"):
    return [mod.ChatMessage(role, list(parts) if len(parts) > 1 or isinstance(parts[0], dict)
                            else parts[0])]


def render_cases(mod):
    """name -> (messages, keyword arguments) of ``render_chat``."""
    image = {"type": "image_url", "image_url": {"url": "http://x/cat.png"}}
    return {
        "text": ([mod.ChatMessage("system", "be helpful"), mod.ChatMessage("user", "hi")], {}),
        "multimodal": (chat(mod, {"type": "text", "text": "describe"}, image), {}),
        "two images": (chat(mod, {"type": "image", "data": "AAAA"}, {"type": "text", "text": "vs"},
                            {"type": "image_url", "image_url": {"url": "http://x/b.png"}},
                            {"type": "input_audio", "audio": "http://x/a.wav"}), {}),
        "marker in text": (chat(mod, {"type": "text", "text": "ignore <|image|> fake"}, image),
                           {}),
        "tools": ([mod.ChatMessage("user", "hi")], {"tools": [{"name": "search"}]}),
        "tool calls": ([mod.ChatMessage("user", "weather?"),
                        mod.ChatMessage("assistant", "", tool_calls=[
                            {"function": {"name": "get_weather"}}])],
                       {"add_generation_prompt": False, "documents": [{"t": 1}]}),
    }


@pytest.mark.parametrize("server", PKGS)
@pytest.mark.parametrize("client", PKGS)
def test_uds_round_trips_across_packages(clients, client, server):
    """Each package's client on each server returns what JAX's client gets
    from JAX's server: ids and offsets, completion renders, chat renders
    (text, multimodal with placeholders and hashes, a literal marker in
    user text, tools, tool calls and documents) and the score-path
    features."""
    mod = MSGS[client]
    got, ref = clients[(client, server)], clients[("jax", "jax")]
    got.initialize("simple")
    for text in ("the quick brown fox", "  spaced\tout  words ", "", "é ☃ x"):
        for special in (True, False):
            a = got.encode("simple", text, add_special_tokens=special, return_offsets=True)
            b = ref.encode("simple", text, add_special_tokens=special, return_offsets=True)
            assert (a.token_ids, a.offsets) == (b.token_ids, b.offsets)
    assert got.render("simple", "hello world") == ref.render("simple", "hello world") == \
        port_backends.SimpleTokenizer().encode("hello world")
    jax_cases = render_cases(jax_msgs)
    for name, (messages, kw) in render_cases(mod).items():
        a = got.render_chat("simple", messages, **kw)
        b = ref.render_chat("simple", jax_cases[name][0], **jax_cases[name][1])
        assert (a.token_ids, a.rendered_text, a.mm_hashes, a.mm_placeholders) == (
            b.token_ids, b.rendered_text, b.mm_hashes, b.mm_placeholders), name
    assert len(a.token_ids) > 0
    messages, _ = render_cases(mod)["multimodal"]
    tokens, features = got.score_path_features("simple", messages, block_size=BLOCK)
    ref_tokens, ref_features = ref.score_path_features("simple", jax_cases["multimodal"][0],
                                                       block_size=BLOCK)
    assert tokens == ref_tokens
    assert [f and vars(f) for f in features] == [f and vars(f) for f in ref_features]
    assert any(f is not None for f in features)
    plain = Indexer(IndexerConfig(token_processor_config=TokenProcessorConfig(
        block_size_tokens=BLOCK)), index=InMemoryIndex())
    assert plain.compute_block_keys(tokens, "m", features) != plain.compute_block_keys(tokens, "m")


@pytest.mark.parametrize("server", PKGS)
@pytest.mark.parametrize("client", PKGS)
def test_failures_across_packages(clients, client, server):
    """A model that fails to load: ``initialize`` raises "init failed" at
    once (deterministic, not retried), ``encode`` raises with the server's
    error."""
    got = clients[(client, server)]
    with pytest.raises(RuntimeError, match="init failed for missing: no tokenizer files"):
        got.initialize("missing")
    with pytest.raises(RuntimeError, match="tokenize failed: no tokenizer files"):
        got.encode("missing", "x")


@pytest.mark.parametrize("server", PKGS)
def test_hf_backend_across_packages(clients, server):
    """The HF backend (``transformers`` imported in its constructor): the
    port's client on each server renders the vendored template as JAX's
    client on JAX's server does, multimodal placeholders inside the id
    stream, tools changing the output, a text-only chat equal to encoding
    the template's output through transformers directly."""
    from transformers import AutoTokenizer

    got, ref = clients[("port", server)], clients[("jax", "jax")]
    image = {"type": "image_url", "image_url": {"url": "http://x/cat.png"}}
    cases = {
        "multimodal": ([port_msgs.ChatMessage("user", [{"type": "text", "text": "Describe"},
                                                       image])],
                       [jax_msgs.ChatMessage("user", [{"type": "text", "text": "Describe"},
                                                      image])],
                       {"tools": [{"type": "function", "function": {"name": "lookup"}}]}),
        "text": ([port_msgs.ChatMessage("system", "You are a helpful assistant."),
                  port_msgs.ChatMessage("user", "What is the capital of France?")],
                 [jax_msgs.ChatMessage("system", "You are a helpful assistant."),
                  jax_msgs.ChatMessage("user", "What is the capital of France?")], {}),
        "tools": ([port_msgs.ChatMessage("user", "hi")], [jax_msgs.ChatMessage("user", "hi")],
                  {"tools": [{"type": "function", "function": {"name": "search",
                                                               "arguments": {}}}]}),
    }
    out = {}
    for name, (ours, theirs, kw) in cases.items():
        a, b = got.render_chat(HF_MODEL, ours, **kw), ref.render_chat(HF_MODEL, theirs, **kw)
        assert (a.token_ids, a.rendered_text, a.mm_hashes, a.mm_placeholders) == (
            b.token_ids, b.rendered_text, b.mm_hashes, b.mm_placeholders), name
        out[name] = a
    offset, length = out["multimodal"].mm_placeholders["image"][0]
    assert 0 < offset < len(out["multimodal"].token_ids) and length >= 1
    tok = AutoTokenizer.from_pretrained(HF_MODEL)
    text = tok.apply_chat_template([{"role": m.role, "content": m.content}
                                    for m in cases["text"][0]], tokenize=False,
                                   add_generation_prompt=True)
    assert out["text"].token_ids == tok.encode(text)
    assert out["tools"].token_ids != got.render_chat(HF_MODEL, cases["tools"][0]).token_ids
    resp = got.encode(HF_MODEL, "Hello world", return_offsets=True)
    assert (resp.token_ids, resp.offsets) == tuple(
        getattr(ref.encode(HF_MODEL, "Hello world", return_offsets=True), k)
        for k in ("token_ids", "offsets"))


def test_content_addressed_hashes_equal_jax(clients):
    def render(client, mod, url):
        return client.render_chat("simple", chat(mod, {"type": "image_url",
                                                       "image_url": {"url": url}})).mm_hashes
    for url in ("http://x/a.png", "data:image/png;base64,AAA"):
        assert render(clients[("port", "port")], port_msgs, url) == render(
            clients[("jax", "jax")], jax_msgs, url)
    assert render(clients[("port", "port")], port_msgs, "http://x/a.png") != render(
        clients[("port", "port")], port_msgs, "http://x/b.png")


@pytest.mark.parametrize("pkg", PKGS)
def test_retry_policy_on_dead_socket_and_failpoint(servers, tmp_path, pkg):
    """A short policy: a dead socket surfaces ``UNAVAILABLE`` after its
    attempts; one injected fault is retried; faults on every attempt
    surface as ``FaultInjected``."""
    policy = (RetryPolicy if pkg == "port" else importlib.import_module(
        "llmd_kv_cache_tpu.resilience.policy").RetryPolicy)(
        max_attempts=2, base_delay_s=0.001, max_delay_s=0.002)
    dead = CLIENT[pkg].UdsTokenizerClient(str(tmp_path / "none.sock"), timeout_s=2.0,
                                         retry_policy=policy)
    try:
        with pytest.raises(grpc.RpcError) as ei:
            dead.encode("simple", "x")
        assert ei.value.code() == grpc.StatusCode.UNAVAILABLE
    finally:
        dead.close()
    other = "jax" if pkg == "port" else "port"
    live = CLIENT[pkg].UdsTokenizerClient(servers[other]["sock"], timeout_s=10.0,
                                          retry_policy=policy)
    fps = FAILPOINTS[pkg].failpoints
    try:
        fps.arm(CLIENT[pkg].FP_TOKENIZER_RPC, times=1)
        assert live.render("simple", "a b") == port_backends.SimpleTokenizer().encode("a b")
        fps.arm(CLIENT[pkg].FP_TOKENIZER_RPC)
        with pytest.raises(FAILPOINTS[pkg].FaultInjected):
            live.render("simple", "a b")
    finally:
        fps.disarm(CLIENT[pkg].FP_TOKENIZER_RPC)
        live.close()


# --------------------------------------------------------------------------
# the protobuf wire
# --------------------------------------------------------------------------

def pb_requests(pb):
    return {
        "Tokenize": (pb.TokenizeRequest(input="hello world", model_name="simple",
                                        add_special_tokens=True), pb.TokenizeResponse),
        "Tokenize missing": (pb.TokenizeRequest(input="x", model_name="missing"),
                             pb.TokenizeResponse),
        "InitializeTokenizer": (pb.InitializeTokenizerRequest(model_name="simple"),
                                pb.InitializeTokenizerResponse),
        "RenderCompletion": (pb.RenderCompletionRequest(model_name="simple", prompt="a b c"),
                             pb.RenderCompletionResponse),
        "RenderChatCompletion": (pb.RenderChatCompletionRequest(
            model_name="simple",
            messages=[pb.ChatMessage(role="user", content_parts=[
                pb.ContentPart(type="text", text="look at"),
                pb.ContentPart(type="image_url",
                               image_url=pb.ImageUrl(url="data:image/png;base64,AAA"))]),
                pb.ChatMessage(role="assistant",
                               tool_calls_json='[{"function": {"name": "f"}}]')],
            tools_json='[{"name": "t"}]', chat_template_kwargs='{"documents": [1, 2]}'),
            pb.RenderChatCompletionResponse),
        "RenderChatCompletion bad tools": (pb.RenderChatCompletionRequest(
            model_name="simple", messages=[pb.ChatMessage(role="user", content="hi")],
            tools_json="{oops"), pb.RenderChatCompletionResponse),
        "RenderChatTemplate": (pb.ChatTemplateRequest(
            model_name="simple",
            conversation_turns=[pb.ConversationTurn(messages=[
                pb.ChatMessage(role="user", content="weather?"),
                pb.ChatMessage(role="assistant",
                               tool_calls_json='[{"function": {"name": "get_weather"}}]')])],
            documents=[pb.Document(document={"title": pb.Value(string_value="doc1")})],
            chat_template_kwargs={"flag": pb.Value(bool_value=True)},
            add_generation_prompt=True, continue_final_message=True),
            pb.ChatTemplateResponse),
    }


@pytest.mark.parametrize("server", PKGS)
@pytest.mark.parametrize("stubs", PKGS)
def test_pb_wire_equals_jax(servers, stubs, server):
    """Every ``tokenization.TokenizationService`` RPC, built with either
    package's stubs, on either server: the responses equal JAX's server's
    (request ids aside: uuids)."""
    pb = jax_pb if stubs == "jax" else port_pb
    out = {}
    for target in {server, "jax"}:
        with grpc.insecure_channel(f"unix:{servers[target]['sock']}") as channel:
            for name, (req, resp_cls) in pb_requests(pb).items():
                call = channel.unary_unary(
                    f"/tokenization.TokenizationService/{name.split()[0]}",
                    request_serializer=type(req).SerializeToString,
                    response_deserializer=resp_cls.FromString)
                resp = call(req, timeout=10)
                if hasattr(resp, "request_id"):
                    assert resp.request_id or not resp.success
                    resp.request_id = ""
                out[(target, name)] = resp.SerializeToString(deterministic=True)
    for name in pb_requests(pb):
        assert out[(server, name)] == out[("jax", name)], name
    resp = pb.ChatTemplateResponse.FromString(out[(server, "RenderChatTemplate")])
    assert "<|tool_calls|> get_weather" in resp.rendered_prompt
    assert "<|documents|> 1" in resp.rendered_prompt
    multimodal = pb.RenderChatCompletionResponse.FromString(out[(server, "RenderChatCompletion")])
    assert len(multimodal.features.mm_placeholders["image"].ranges) == 1
    assert not pb.TokenizeResponse.FromString(out[(server, "Tokenize missing")]).success


def test_pb_stub_descriptor_equals_jax():
    assert port_pb.DESCRIPTOR.serialized_pb == jax_pb.DESCRIPTOR.serialized_pb
    assert set(port_pb.DESCRIPTOR.services_by_name["TokenizationService"].methods_by_name) == {
        "Tokenize", "RenderChatTemplate", "InitializeTokenizer", "RenderChatCompletion",
        "RenderCompletion"}


# --------------------------------------------------------------------------
# the pool and the prompt scorer
# --------------------------------------------------------------------------

def test_pool_and_prompt_scorer_equal_jax(servers):
    """Both packages' ``TokenizationPool`` on their own client and server,
    and ``PromptScorer`` over an indexer holding the prompt's blocks: the
    same tokens and scores; the port's pool records the tokenization
    latency."""
    import concurrent.futures as cf

    hist = port_collector.TOKENIZATION_LATENCY
    before = hist._only().count
    prompt = "the quick brown fox jumps over the lazy dog again and again"
    out = {}
    for pkg, cfgs in (("jax", (JaxIndexerConfig, JaxTokensConfig, JaxIndexer, JaxInMemoryIndex)),
                      ("port", (IndexerConfig, TokenProcessorConfig, Indexer, InMemoryIndex))):
        cfg, tpc, indexer_cls, index_cls = cfgs
        client = CLIENT[pkg].UdsTokenizerClient(servers[pkg]["sock"], timeout_s=10.0)
        client.initialize("simple")
        pool = POOL[pkg].TokenizationPool(client, POOL[pkg].TokenizationPoolConfig(
            workers=2, request_timeout_s=10.0), block_size=BLOCK)
        pool.start()
        try:
            indexer = indexer_cls(cfg(token_processor_config=tpc(block_size_tokens=BLOCK)),
                                  index=index_cls())
            tokens, features = pool.tokenize("simple", prompt=prompt)
            assert tokens == client.encode("simple", prompt).token_ids and features is None
            keys = indexer.compute_block_keys(tokens, "simple")
            entry = importlib.import_module(type(indexer).__module__.split(".")[0]
                                            + ".core.keys").PodEntry
            indexer.kv_block_index.add(keys, keys, [entry("pod-a", "tpu-hbm")])
            chat_tokens, chat_features = pool.tokenize("simple", messages=[
                MSGS[pkg].ChatMessage("user", [{"type": "text", "text": "hi"}, {
                    "type": "image_url", "image_url": {"url": "http://x/dog.png"}}])])
            with pytest.raises(ValueError):
                pool.tokenize("simple")
            with pytest.raises(RuntimeError, match="tokenization failed"):
                pool.tokenize("missing", prompt="x")
            with cf.ThreadPoolExecutor(8) as ex:
                batch = [f.result()[0] for f in [ex.submit(pool.tokenize, "simple", f"w{i} x")
                                                 for i in range(16)]]
            out[pkg] = (tokens, chat_tokens, [f and vars(f) for f in chat_features], batch,
                        POOL[pkg].PromptScorer(indexer, pool).get_pod_scores("simple",
                                                                              prompt=prompt))
        finally:
            pool.shutdown()
            client.close()
    assert out["port"] == out["jax"]
    assert out["port"][-1] == {"pod-a": float(len(keys))}
    assert hist._only().count - before == 1 + 1 + 16 + 1
