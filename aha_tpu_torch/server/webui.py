"""The web console served at GET / (the port's copy of
aha_tpu/server/webui.py; INDEX_HTML is the same page, byte for byte).

One self-contained page, no build step: chat, transcription, speech and
background-removal tabs; a Models tab (list, download, delete, serve,
stop) over /manage; Settings (save directory, theme, serve defaults)
over /manage/settings; Usage (curl / python snippets with the host
filled in); Logs over /manage/logs.  It calls only the server's public
routes.
"""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>aha console</title>
<style>
  :root {
    --bg: #0f1117; --panel: #181b24; --panel2: #1f2330; --text: #e6e8ee;
    --dim: #8b90a0; --accent: #6ea8fe; --ok: #4ade80; --err: #f87171;
    --think: #2a2f3f;
  }
  body.light {
    --bg: #f5f6f8; --panel: #ffffff; --panel2: #eef0f4; --text: #1a1d26;
    --dim: #667085; --accent: #2563eb; --think: #e5e8f0;
  }
  * { box-sizing: border-box; }
  .snippet { margin: 14px 0; }
  .snippet h3 { font-size: 13px; margin: 0 0 6px; }
  .snippet pre { background: var(--panel2); border-radius: 10px;
    padding: 10px 12px; font-size: 12px; overflow-x: auto; margin: 0;
    position: relative; white-space: pre-wrap; word-break: break-all; }
  .snippet button { float: right; background: none; border: 1px solid #2c3242;
    color: var(--dim); border-radius: 6px; cursor: pointer; font-size: 11px;
    padding: 2px 8px; margin-left: 8px; }
  body { margin: 0; background: var(--bg); color: var(--text);
         font: 14px/1.5 system-ui, sans-serif; height: 100vh;
         display: flex; flex-direction: column; }
  header { display: flex; align-items: center; gap: 12px;
           padding: 10px 16px; background: var(--panel);
           border-bottom: 1px solid #262b38; }
  header h1 { font-size: 15px; margin: 0; font-weight: 600; }
  #model-badge { color: var(--accent); font-family: ui-monospace, monospace;
                 font-size: 13px; }
  #health { margin-left: auto; font-size: 12px; color: var(--dim); }
  #health.ok::before { content: "● "; color: var(--ok); }
  #health.err::before { content: "● "; color: var(--err); }
  nav { display: flex; gap: 4px; padding: 8px 16px 0; background: var(--panel); }
  nav button { background: none; border: none; color: var(--dim);
               padding: 8px 14px; cursor: pointer; font-size: 13px;
               border-bottom: 2px solid transparent; }
  nav button.active { color: var(--text); border-color: var(--accent); }
  main { flex: 1; overflow: hidden; display: flex; }
  .tab { display: none; flex: 1; flex-direction: column; padding: 16px;
         overflow: hidden; }
  .tab.active { display: flex; }
  #chat-log { flex: 1; overflow-y: auto; display: flex;
              flex-direction: column; gap: 10px; padding-bottom: 10px; }
  .msg { max-width: 82%; padding: 10px 14px; border-radius: 12px;
         white-space: pre-wrap; word-break: break-word; }
  .msg.user { align-self: flex-end; background: #2b3a55; }
  .msg.assistant { align-self: flex-start; background: var(--panel2); }
  .msg .think { display: block; color: var(--dim); font-size: 12px;
                background: var(--think); border-radius: 8px;
                padding: 6px 10px; margin-bottom: 8px; }
  .msg .usage { display: block; color: var(--dim); font-size: 11px;
                margin-top: 8px; }
  form.bar { display: flex; gap: 8px; margin-top: 10px; }
  textarea, input[type=text] { flex: 1; background: var(--panel2);
    border: 1px solid #2c3242; color: var(--text); border-radius: 10px;
    padding: 10px 12px; font: inherit; resize: none; }
  button.send { background: var(--accent); color: #0c1220; border: none;
    border-radius: 10px; padding: 0 18px; font-weight: 600; cursor: pointer; }
  button.send:disabled { opacity: .5; cursor: default; }
  .pane { background: var(--panel); border-radius: 12px; padding: 16px;
          max-width: 680px; }
  .pane h2 { margin: 0 0 10px; font-size: 14px; }
  .pane .row { display: flex; gap: 8px; margin: 10px 0; align-items: center; }
  .out { margin-top: 12px; color: var(--dim); white-space: pre-wrap; }
  .out img { max-width: 100%; border-radius: 8px;
             background: repeating-conic-gradient(#333 0 25%, #444 0 50%)
                         0 0 / 20px 20px; }
  audio { width: 100%; margin-top: 8px; }
</style>
</head>
<body>
<header>
  <h1>aha</h1>
  <span id="model-badge">loading…</span>
  <span id="health">checking…</span>
</header>
<nav>
  <button data-tab="chat" class="active">Chat</button>
  <button data-tab="asr">Transcribe</button>
  <button data-tab="tts">Speech</button>
  <button data-tab="rmbg">Remove background</button>
  <button data-tab="models">Models</button>
  <button data-tab="usage">Usage</button>
  <button data-tab="settings">Settings</button>
  <button data-tab="logs">Logs</button>
</nav>
<main>
  <section id="tab-chat" class="tab active">
    <div id="chat-log"></div>
    <form class="bar" id="chat-form">
      <textarea id="chat-input" rows="2"
        placeholder="Message the model…  (Enter to send, Shift+Enter for newline)"></textarea>
      <button class="send" id="chat-send">Send</button>
    </form>
  </section>
  <section id="tab-asr" class="tab">
    <div class="pane">
      <h2>Audio transcription — POST /v1/audio/transcriptions</h2>
      <div class="row"><input type="file" id="asr-file"
        accept=".wav,.mp3,.ogg,.flac,audio/*">
        <button class="send" id="asr-send">Transcribe</button></div>
      <div class="out" id="asr-out"></div>
    </div>
  </section>
  <section id="tab-tts" class="tab">
    <div class="pane">
      <h2>Text to speech — POST /audio/speech</h2>
      <div class="row"><input type="text" id="tts-text"
        placeholder="Text to speak…">
        <button class="send" id="tts-send">Speak</button></div>
      <div class="out" id="tts-out"></div>
    </div>
  </section>
  <section id="tab-rmbg" class="tab">
    <div class="pane">
      <h2>Background removal — POST /images/remove_background</h2>
      <div class="row"><input type="file" id="rmbg-file" accept="image/*">
        <button class="send" id="rmbg-send">Remove</button></div>
      <div class="out" id="rmbg-out"></div>
    </div>
  </section>
  <section id="tab-models" class="tab">
    <div class="pane" style="overflow:auto">
      <h2>Model manager — /manage</h2>
      <div class="row">
        <button class="send" id="models-refresh">Refresh</button>
        <span id="models-savedir" style="color:var(--dim);font-size:12px"></span>
      </div>
      <table id="models-table" style="width:100%;border-collapse:collapse;
        font-size:13px"><thead><tr style="color:var(--dim);text-align:left">
        <th style="padding:6px">Model</th><th>Type</th><th>Status</th>
        <th>Actions</th></tr></thead><tbody></tbody></table>
      <h2 style="margin-top:18px">Servers</h2>
      <div class="row">
        <select id="serve-model" style="background:var(--panel2);
          color:var(--text);border:1px solid #2c3242;border-radius:10px;
          padding:8px"></select>
        <input type="text" id="serve-port" value="8001"
          style="max-width:90px" title="port">
        <input type="text" id="serve-batch" value="" placeholder="slots"
          style="max-width:70px" title="--batch-slots (continuous batching)">
        <input type="text" id="serve-tp" value="" placeholder="tp"
          style="max-width:60px" title="--tp (tensor-parallel degree)">
        <input type="text" id="serve-dp" value="" placeholder="dp"
          style="max-width:60px"
          title="--dp (data-parallel slot sharding; slots % dp == 0)">
        <input type="text" id="serve-spec" value="" placeholder="spec"
          style="max-width:70px"
          title="--spec-tokens (speculative decoding drafts)">
        <button class="send" id="serve-start">Start server</button>
      </div>
      <div class="out" id="services-out"></div>
    </div>
  </section>
  <section id="tab-usage" class="tab">
    <div class="pane" style="overflow:auto;max-width:860px">
      <h2>API usage</h2>
      <p style="color:var(--dim);margin:4px 0 0">Copy-paste examples for
      this server. Full reference: docs/api.md.</p>
      <div id="usage-blocks"></div>
    </div>
  </section>
  <section id="tab-settings" class="tab">
    <div class="pane">
      <h2>Settings — /manage/settings</h2>
      <div class="row"><label style="min-width:150px">Appearance</label>
        <select id="set-theme" style="background:var(--panel2);
          color:var(--text);border:1px solid #2c3242;border-radius:10px;
          padding:8px"><option value="dark">Dark</option>
          <option value="light">Light</option></select></div>
      <div class="row"><label style="min-width:150px">Model save dir</label>
        <input type="text" id="set-savedir" placeholder="(default)">
      </div>
      <div class="row"><label style="min-width:150px">API key</label>
        <input type="password" id="set-apikey"
          placeholder="(none — only needed when the server runs --api-key)">
      </div>
      <div class="row" style="color:var(--dim);font-size:12px">
        <span>Stored in this browser only; sent as
        "Authorization: Bearer …" on every console request.</span></div>
      <div class="row" style="color:var(--dim);font-size:12px">
        <span id="set-savedir-hint"></span></div>
      <h2 style="margin-top:18px">Serve defaults</h2>
      <p style="color:var(--dim);font-size:12px;margin:0 0 8px">Pre-filled
      into the Models tab's server form and applied to spawned servers when
      the form field is left blank.</p>
      <div class="row">
        <input type="text" id="setd-port" placeholder="port"
          style="max-width:90px" title="default port">
        <input type="text" id="setd-batch_slots" placeholder="slots"
          style="max-width:70px" title="--batch-slots">
        <input type="text" id="setd-tp" placeholder="tp"
          style="max-width:60px" title="--tp">
        <input type="text" id="setd-dp" placeholder="dp"
          style="max-width:60px" title="--dp">
        <input type="text" id="setd-spec_tokens" placeholder="spec"
          style="max-width:70px" title="--spec-tokens">
        <input type="text" id="setd-max_seq_len" placeholder="max seq"
          style="max-width:90px" title="--max-seq-len">
      </div>
      <div class="row">
        <button class="send" id="settings-save">Save</button>
        <span id="settings-out" style="color:var(--dim)"></span></div>
    </div>
  </section>
  <section id="tab-logs" class="tab">
    <div class="pane" style="flex:1;display:flex;flex-direction:column">
      <h2>Server logs — GET /manage/logs</h2>
      <div class="row"><button class="send" id="logs-clear">Clear</button>
      </div>
      <pre id="logs-out" style="flex:1;overflow:auto;background:var(--panel2);
        border-radius:10px;padding:10px;font-size:12px;margin:0"></pre>
    </div>
  </section>
</main>
<script>
const $ = (id) => document.getElementById(id);
let modelId = "";
const history = [];

// attach the stored API key (settings tab) to every console request; the
// server enforces it when started with --api-key / AHA_API_KEY
const _fetch = window.fetch.bind(window);
window.fetch = (url, opts = {}) => {
  const key = localStorage.getItem("aha-api-key");
  if (key) {
    // new Headers() accepts undefined, plain objects, and Headers
    // instances alike (Headers entries aren't enumerable own properties,
    // so Object.assign would silently drop them)
    const h = new Headers(opts.headers);
    h.set("Authorization", "Bearer " + key);
    opts.headers = h;
  }
  return _fetch(url, opts);
};

async function refreshStatus() {
  try {
    const h = await fetch("/health");
    $("health").textContent = h.ok ? "healthy" : "unhealthy";
    $("health").className = h.ok ? "ok" : "err";
    const m = await (await fetch("/models")).json();
    modelId = (m.data && m.data[0] && m.data[0].id) || "";
    $("model-badge").textContent = modelId || "no model";
  } catch (e) {
    $("health").textContent = "unreachable"; $("health").className = "err";
  }
}
refreshStatus(); setInterval(refreshStatus, 10000);

document.querySelectorAll("nav button").forEach(b => b.onclick = () => {
  document.querySelectorAll("nav button").forEach(x =>
    x.classList.toggle("active", x === b));
  document.querySelectorAll(".tab").forEach(t =>
    t.classList.toggle("active", t.id === "tab-" + b.dataset.tab));
});

function addMsg(role) {
  const div = document.createElement("div");
  div.className = "msg " + role;
  $("chat-log").appendChild(div);
  $("chat-log").scrollTop = 1e9;
  return div;
}

async function sendChat(ev) {
  ev.preventDefault();
  const text = $("chat-input").value.trim();
  if (!text) return;
  $("chat-input").value = "";
  $("chat-send").disabled = true;
  addMsg("user").textContent = text;
  history.push({role: "user", content: text});
  const out = addMsg("assistant");
  const think = document.createElement("span"); think.className = "think";
  const body = document.createElement("span");
  let content = "", reasoning = "";
  try {
    const r = await fetch("/v1/chat/completions", {
      method: "POST", headers: {"Content-Type": "application/json"},
      body: JSON.stringify({model: modelId, messages: history, stream: true}),
    });
    if (!r.ok) throw new Error(await r.text());
    const reader = r.body.getReader();
    const dec = new TextDecoder();
    let buf = "";
    for (;;) {
      const {done, value} = await reader.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      let i;
      while ((i = buf.indexOf("\\n\\n")) >= 0) {
        const line = buf.slice(0, i).trim(); buf = buf.slice(i + 2);
        if (!line.startsWith("data:")) continue;
        const payload = line.slice(5).trim();
        if (payload === "[DONE]") continue;
        const chunk = JSON.parse(payload);
        const d = chunk.choices && chunk.choices[0] && chunk.choices[0].delta;
        if (d && d.reasoning_content) {
          reasoning += d.reasoning_content;
          if (!think.parentNode) out.appendChild(think);
          think.textContent = reasoning;
        }
        if (d && d.content) { content += d.content; }
        if (!body.parentNode) out.appendChild(body);
        body.textContent = content;
        if (chunk.usage) {
          const u = chunk.usage;
          const span = document.createElement("span");
          span.className = "usage";
          span.textContent = u.prompt_tokens + " prompt tok · "
            + u.completion_tokens + " completion tok · "
            + (u.completion_tps || 0).toFixed(1) + " tok/s";
          out.appendChild(span);
        }
        $("chat-log").scrollTop = 1e9;
      }
    }
    history.push({role: "assistant", content});
  } catch (e) {
    body.textContent = "error: " + e.message;
    if (!body.parentNode) out.appendChild(body);
  }
  $("chat-send").disabled = false;
}
$("chat-form").onsubmit = sendChat;
$("chat-input").addEventListener("keydown", (e) => {
  if (e.key === "Enter" && !e.shiftKey) sendChat(e);
});

$("asr-send").onclick = async () => {
  const f = $("asr-file").files[0];
  if (!f) return;
  $("asr-out").textContent = "transcribing…";
  const fd = new FormData();
  fd.append("file", f, f.name);
  try {
    const r = await fetch("/v1/audio/transcriptions", {method: "POST", body: fd});
    const t = await r.text();
    $("asr-out").textContent = r.ok ? (JSON.parse(t).text || t) : t;
  } catch (e) { $("asr-out").textContent = "error: " + e.message; }
};

$("tts-send").onclick = async () => {
  const text = $("tts-text").value.trim();
  if (!text) return;
  $("tts-out").textContent = "synthesizing…";
  try {
    const r = await fetch("/audio/speech", {
      method: "POST", headers: {"Content-Type": "application/json"},
      body: JSON.stringify({model: modelId, messages: [
        {role: "user", content: text}]}),
    });
    const t = await r.text();
    if (!r.ok) throw new Error(t);
    const resp = JSON.parse(t);
    const part = resp.choices[0].message.content;
    const b64 = Array.isArray(part)
      ? (part.find(p => p.type === "audio") || {}).audio_url.url
      : part;
    const src = b64.startsWith("data:") ? b64 : "data:audio/wav;base64," + b64;
    $("tts-out").innerHTML = "";
    const a = document.createElement("audio");
    a.controls = true; a.src = src;
    $("tts-out").appendChild(a);
  } catch (e) { $("tts-out").textContent = "error: " + e.message; }
};

$("rmbg-send").onclick = async () => {
  const f = $("rmbg-file").files[0];
  if (!f) return;
  $("rmbg-out").textContent = "processing…";
  const toB64 = (file) => new Promise((res, rej) => {
    const fr = new FileReader();
    fr.onload = () => res(fr.result); fr.onerror = rej;
    fr.readAsDataURL(file);
  });
  try {
    const dataUrl = await toB64(f);
    const r = await fetch("/images/remove_background", {
      method: "POST", headers: {"Content-Type": "application/json"},
      body: JSON.stringify({model: modelId, messages: [{role: "user",
        content: [{type: "image_url", image_url: {url: dataUrl}}]}]}),
    });
    const t = await r.text();
    if (!r.ok) throw new Error(t);
    const resp = JSON.parse(t);
    const parts = resp.choices[0].message.content;
    $("rmbg-out").innerHTML = "";
    (Array.isArray(parts) ? parts : [parts]).forEach(p => {
      const url = p.image_url ? p.image_url.url : p;
      const img = document.createElement("img");
      img.src = url.startsWith("data:") ? url : "data:image/png;base64," + url;
      $("rmbg-out").appendChild(img);
    });
  } catch (e) { $("rmbg-out").textContent = "error: " + e.message; }
};

// ---- model manager ----
const fmtB = (n) => n > 1e9 ? (n/1e9).toFixed(1)+" GB"
  : n > 1e6 ? (n/1e6).toFixed(0)+" MB" : n > 0 ? (n/1e3).toFixed(0)+" kB" : "";
async function refreshModels() {
  try {
    const data = await (await fetch("/manage/models")).json();
    $("models-savedir").textContent = "weights dir: " + data.save_dir;
    const tb = $("models-table").querySelector("tbody");
    tb.innerHTML = "";
    const sel = $("serve-model"); sel.innerHTML = "";
    data.models.forEach(m => {
      const tr = document.createElement("tr");
      tr.style.borderTop = "1px solid #262b38";
      let status = m.downloaded ? "✔ " + fmtB(m.bytes) : "—";
      if (m.download && m.download.status === "downloading") {
        const pct = m.download.bytes_total
          ? Math.round(100 * m.download.bytes_done / m.download.bytes_total)
          : 0;
        status = `⬇ ${pct}% (${fmtB(m.download.bytes_done)})`;
      } else if (m.download && m.download.status === "error") {
        status = "✗ " + m.download.error;
      }
      tr.innerHTML = `<td style="padding:6px;font-family:monospace">
        ${m.model_id}</td><td>${m.model_type}</td><td>${status}</td><td></td>`;
      const td = tr.lastElementChild;
      const mk = (label, fn) => { const b = document.createElement("button");
        b.className = "send"; b.style.padding = "4px 10px";
        b.style.marginRight = "6px"; b.textContent = label; b.onclick = fn;
        td.appendChild(b); };
      if (!m.downloaded) mk("Download", async () => {
        await fetch("/manage/download", {method: "POST",
          headers: {"Content-Type": "application/json"},
          body: JSON.stringify({model: m.model_id})});
        pollModels();
      });
      else mk("Delete", async () => {
        if (!confirm("Delete " + m.model_id + "?")) return;
        await fetch("/manage/delete", {method: "POST",
          headers: {"Content-Type": "application/json"},
          body: JSON.stringify({model: m.model_id})});
        refreshModels();
      });
      tb.appendChild(tr);
      if (m.downloaded) {
        const o = document.createElement("option");
        o.value = m.model_id; o.textContent = m.model_id;
        sel.appendChild(o);
      }
    });
    const svc = await (await fetch("/manage/services")).json();
    $("services-out").textContent = svc.services.length
      ? svc.services.map(s =>
          `pid ${s.pid}  port ${s.port}  ${s.model || ""}  [${s.status}]`
        ).join("\\n")
      : "no running aha services";
    svc.services.forEach(s => {
      if (s.port === Number(location.port || 80)) return;
      const b = document.createElement("button");
      b.className = "send"; b.style.marginTop = "6px";
      b.textContent = "Stop :" + s.port;
      b.onclick = async () => {
        await fetch("/manage/stop", {method: "POST",
          headers: {"Content-Type": "application/json"},
          body: JSON.stringify({port: s.port})});
        setTimeout(refreshModels, 500);
      };
      $("services-out").appendChild(document.createElement("br"));
      $("services-out").appendChild(b);
    });
  } catch (e) { $("services-out").textContent = "error: " + e.message; }
}
let modelsPoll = null;
function pollModels() {
  if (modelsPoll) return;
  modelsPoll = setInterval(async () => {
    await refreshModels();
    const data = await (await fetch("/manage/models")).json();
    if (!data.models.some(m => m.download &&
                          m.download.status === "downloading")) {
      clearInterval(modelsPoll); modelsPoll = null;
    }
  }, 1500);
}
$("models-refresh").onclick = refreshModels;
$("serve-start").onclick = async () => {
  await fetch("/manage/serve", {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify({model: $("serve-model").value,
                          port: Number($("serve-port").value),
                          batch_slots: Number($("serve-batch").value) || null,
                          tp: Number($("serve-tp").value) || null,
                          dp: Number($("serve-dp").value) || null,
                          spec_tokens: Number($("serve-spec").value) || null})});
  setTimeout(refreshModels, 1000);
};
document.querySelector('nav button[data-tab="models"]')
  .addEventListener("click", refreshModels);

// ---- logs ----
let logOffset = 0, logsTimer = null;
async function pollLogs() {
  try {
    const data = await (await fetch("/manage/logs?offset=" + logOffset)).json();
    if (data.lines.length) {
      $("logs-out").textContent += data.lines.map(l =>
        `[${l.source}] ${l.line}`).join("\\n") + "\\n";
      $("logs-out").scrollTop = 1e9;
    }
    logOffset = data.next;
  } catch (e) {}
}
document.querySelector('nav button[data-tab="logs"]')
  .addEventListener("click", () => {
    pollLogs();
    if (!logsTimer) logsTimer = setInterval(pollLogs, 2000);
  });
$("logs-clear").onclick = async () => {
  await fetch("/manage/logs/clear", {method: "POST"});
  $("logs-out").textContent = ""; logOffset = 0;
};

// ---- settings (aha-ui/src/features/settings: model save dir +
// appearance theme + serve defaults) ----
const SDK = ["port", "batch_slots", "tp", "dp", "spec_tokens", "max_seq_len"];
function applyTheme(t) {
  document.body.classList.toggle("light", t === "light");
  localStorage.setItem("aha-theme", t);
  $("set-theme").value = t;
}
applyTheme(localStorage.getItem("aha-theme") || "dark");
$("set-theme").onchange = () => applyTheme($("set-theme").value);

async function loadSettings() {
  try {
    const s = await (await fetch("/manage/settings")).json();
    $("set-apikey").value = localStorage.getItem("aha-api-key") || "";
    $("set-savedir").value = s.save_dir || "";
    $("set-savedir-hint").textContent =
      "effective: " + s.effective_save_dir +
      (s.save_dir ? "" : " (default " + s.default_save_dir + ")");
    SDK.forEach(k => {
      $("setd-" + k).value = (s.serve_defaults || {})[k] ?? "";
    });
    if ((s.serve_defaults || {}).port && !$("serve-port").value)
      $("serve-port").value = s.serve_defaults.port;
    ["batch_slots", "tp", "dp", "spec_tokens"].forEach(k => {
      const map = {batch_slots: "serve-batch", tp: "serve-tp",
                   dp: "serve-dp", spec_tokens: "serve-spec"};
      const v = (s.serve_defaults || {})[k];
      if (v != null && !$(map[k]).value) $(map[k]).placeholder = String(v);
    });
  } catch (e) { $("settings-out").textContent = "error: " + e.message; }
}
$("settings-save").onclick = async () => {
  const key = $("set-apikey").value.trim();
  if (key) localStorage.setItem("aha-api-key", key);
  else localStorage.removeItem("aha-api-key");
  const defaults = {};
  SDK.forEach(k => {
    const v = $("setd-" + k).value.trim();
    if (v) defaults[k] = Number(v) || v;
  });
  const r = await fetch("/manage/settings", {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify({save_dir: $("set-savedir").value.trim(),
                          serve_defaults: defaults})});
  $("settings-out").textContent = r.ok ? "saved" :
    "error: " + await r.text();
  if (r.ok) { loadSettings(); setTimeout(() =>
    $("settings-out").textContent = "", 2000); }
};
document.querySelector('nav button[data-tab="settings"]')
  .addEventListener("click", loadSettings);

// ---- usage (aha-ui/src/features/usage: copyable API snippets) ----
function renderUsage() {
  const host = location.origin;
  const mid = modelId || "<model-id>";
  const blocks = [
    ["Chat completion (curl)", `curl ${host}/v1/chat/completions \\\\
  -H 'Content-Type: application/json' \\\\
  -d '{"model": "${mid}", "stream": true,
       "messages": [{"role": "user", "content": "Hello!"}]}'`],
    ["Chat completion (python / openai sdk)", `from openai import OpenAI
client = OpenAI(base_url="${host}/v1", api_key="unused")
resp = client.chat.completions.create(
    model="${mid}",
    messages=[{"role": "user", "content": "Hello!"}])
print(resp.choices[0].message.content)`],
    ["Audio transcription (curl)", `curl ${host}/v1/audio/transcriptions \\\\
  -F file=@speech.wav -F language=zh`],
    ["Text to speech (curl)", `curl ${host}/audio/speech \\\\
  -H 'Content-Type: application/json' \\\\
  -d '{"model": "${mid}", "messages":
       [{"role": "user", "content": "你好"}]}'`],
    ["Background removal (curl)", `curl ${host}/images/remove_background \\\\
  -H 'Content-Type: application/json' \\\\
  -d '{"model": "${mid}", "messages": [{"role": "user", "content":
       [{"type": "image_url", "image_url": {"url": "file:///abs/img.png"}}]}]}'`],
    ["Embeddings (curl)", `curl ${host}/v1/embeddings \\\\
  -H 'Content-Type: application/json' \\\\
  -d '{"model": "${mid}", "input": ["text one", "text two"]}'`],
    ["Rerank (curl)", `curl ${host}/v1/rerank \\\\
  -H 'Content-Type: application/json' \\\\
  -d '{"model": "${mid}", "query": "what is a TPU?",
       "documents": ["a bird", "a matrix accelerator"], "top_n": 1}'`],
  ];
  const root = $("usage-blocks"); root.innerHTML = "";
  blocks.forEach(([title, code]) => {
    const div = document.createElement("div"); div.className = "snippet";
    const h = document.createElement("h3"); h.textContent = title;
    const pre = document.createElement("pre");
    const btn = document.createElement("button"); btn.textContent = "copy";
    btn.onclick = async () => { await navigator.clipboard.writeText(code);
      btn.textContent = "copied"; setTimeout(() =>
        btn.textContent = "copy", 1500); };
    pre.appendChild(btn);
    pre.appendChild(document.createTextNode(code));
    div.appendChild(h); div.appendChild(pre); root.appendChild(div);
  });
}
document.querySelector('nav button[data-tab="usage"]')
  .addEventListener("click", renderUsage);
</script>
</body>
</html>
"""
