"""OpenAPI serving (counterpart of gofr_tpu/swagger.py): when
``./static/openapi.json`` exists at start-up, ``GET
/.well-known/openapi.json`` serves it (re-read per request) and ``GET
/.well-known/swagger`` a self-contained page that lists the operations by
tag and can execute them against the live server."""

from __future__ import annotations

import os

from .http.request import Request
from .http.responder import Response

_UI_HTML = """<!DOCTYPE html>
<html><head><title>API Docs</title><meta charset="utf-8"><style>
body{font-family:system-ui,sans-serif;margin:2rem auto;max-width:62rem;padding:0 1rem;color:#212529}
h1{margin-bottom:.2rem} .desc{color:#495057;margin:0 0 1.2rem}
h2{font-size:1.05rem;border-bottom:1px solid #dee2e6;padding-bottom:.25rem;margin-top:1.6rem}
details.op{border:1px solid #dee2e6;border-radius:6px;margin:.5rem 0;background:#fff}
details.op>summary{cursor:pointer;padding:.55rem .9rem;list-style:none;display:flex;gap:.8rem;align-items:baseline}
details.op>summary::-webkit-details-marker{display:none}
.body{padding:.4rem .9rem .9rem;border-top:1px solid #f1f3f5}
.m{display:inline-block;min-width:4.2rem;font-weight:700;font-size:.85rem}
.GET{color:#0b7285}.POST{color:#2b8a3e}.PUT{color:#e67700}.DELETE{color:#c92a2a}.PATCH{color:#862e9c}.OPTIONS,.HEAD{color:#495057}
code{background:#f8f9fa;padding:.1rem .3rem;border-radius:4px}
.sum{color:#495057;font-size:.9rem}
table{border-collapse:collapse;width:100%;margin:.4rem 0;font-size:.9rem}
td,th{border:1px solid #e9ecef;padding:.3rem .5rem;text-align:left}
th{background:#f8f9fa}
pre{background:#f8f9fa;padding:.7rem;border-radius:6px;overflow:auto;font-size:.85rem}
textarea{width:100%;min-height:6rem;font-family:monospace;font-size:.85rem}
input[type=text]{font-family:monospace;width:100%;box-sizing:border-box}
button{background:#1971c2;color:#fff;border:0;border-radius:4px;padding:.45rem 1rem;cursor:pointer;margin:.4rem 0}
button:hover{background:#1864ab}
.resp{margin-top:.5rem}.status-ok{color:#2b8a3e;font-weight:700}.status-err{color:#c92a2a;font-weight:700}
summary.sub{cursor:pointer;font-weight:600;margin:.5rem 0 .2rem}
</style></head><body>
<h1 id="title">API</h1><p class="desc" id="descr"></p><div id="ops"></div>
<details><summary class="sub">Raw spec</summary><pre id="raw"></pre></details>
<script>
const esc=x=>String(x??'').replace(/[&<>"]/g,c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;'}[c]));
function schemaText(s, depth){
  if(!s) return 'any';
  if(s.$ref){ return s.$ref.split('/').pop(); }
  if(s.type==='array') return schemaText(s.items, depth)+'[]';
  if(s.type==='object'||s.properties){
    if(depth>3) return 'object';
    const props=Object.entries(s.properties||{}).map(
      ([k,v])=>`  ${'  '.repeat(depth)}${k}: ${schemaText(v,(depth||0)+1)}`);
    return props.length? '{\\n'+props.join(',\\n')+'\\n'+'  '.repeat(depth||0)+'}' : 'object';
  }
  return s.type||'any';
}
function sampleFor(s, defs, depth){
  depth=depth||0;
  if(!s||depth>6) return null;  // recursive $ref schemas must terminate
  if(s.$ref){ const n=s.$ref.split('/').pop(); return sampleFor(defs[n]||{},defs,depth+1); }
  if(s.example!==undefined) return s.example;
  if(s.type==='array') return [sampleFor(s.items,defs,depth+1)];
  if(s.type==='object'||s.properties){
    const o={}; for(const [k,v] of Object.entries(s.properties||{})) o[k]=sampleFor(v,defs,depth+1);
    return o;
  }
  return {string:'',integer:0,number:0,boolean:false}[s.type] ?? null;
}
function render(spec){
  document.getElementById('title').textContent=(spec.info&&spec.info.title)||'API';
  document.getElementById('descr').textContent=(spec.info&&spec.info.description)||'';
  document.getElementById('raw').textContent=JSON.stringify(spec,null,2);
  const defs=(spec.components&&spec.components.schemas)||(spec.definitions)||{};
  const groups={};
  for(const [path,item] of Object.entries(spec.paths||{})){
    for(const [method,op] of Object.entries(item)){
      if(!/^(get|post|put|patch|delete|options|head)$/.test(method)) continue;
      const tag=(op.tags&&op.tags[0])||'default';
      (groups[tag]=groups[tag]||[]).push([path,method,op||{}]);
    }
  }
  const root=document.getElementById('ops');
  for(const [tag,entries] of Object.entries(groups)){
    if(Object.keys(groups).length>1||tag!=='default'){
      const h=document.createElement('h2'); h.textContent=tag; root.appendChild(h);
    }
    for(const [path,method,op] of entries) root.appendChild(renderOp(path,method,op,defs));
  }
}
function renderOp(path,method,op,defs){
  const M=method.toUpperCase();
  const d=document.createElement('details'); d.className='op';
  const params=(op.parameters||[]);
  const reqBody=op.requestBody&&op.requestBody.content&&
    (op.requestBody.content['application/json']||Object.values(op.requestBody.content)[0]);
  let html=`<summary><span class="m ${M}">${M}</span><code>${esc(path)}</code>`+
    `<span class="sum">${esc(op.summary||'')}</span></summary><div class="body">`;
  if(op.description) html+=`<p>${esc(op.description)}</p>`;
  if(params.length){
    html+='<table><tr><th>Parameter</th><th>In</th><th>Type</th><th>Required</th><th>Value</th></tr>';
    params.forEach((p,i)=>{
      html+=`<tr><td>${esc(p.name)}</td><td>${esc(p.in)}</td><td>${esc((p.schema&&p.schema.type)||'string')}</td>`+
        `<td>${p.required?'yes':''}</td><td><input type="text" data-p="${i}"></td></tr>`;
    });
    html+='</table>';
  }
  if(reqBody){
    html+=`<div><b>Request body</b> <code>application/json</code>`+
      `<pre>${esc(schemaText(reqBody.schema,1))}</pre>`+
      `<textarea data-body>${esc(JSON.stringify(sampleFor(reqBody.schema,defs),null,2))}</textarea></div>`;
  }
  const responses=op.responses||{};
  if(Object.keys(responses).length){
    html+='<table><tr><th>Code</th><th>Description</th></tr>';
    for(const [code,r] of Object.entries(responses))
      html+=`<tr><td>${esc(code)}</td><td>${esc((r&&r.description)||'')}</td></tr>`;
    html+='</table>';
  }
  html+='<button data-exec>Execute</button><div class="resp"></div></div>';
  d.innerHTML=html;
  d.querySelector('[data-exec]').addEventListener('click',async()=>{
    let url=path;
    const qs=new URLSearchParams();
    params.forEach((p,i)=>{
      const v=d.querySelector(`[data-p="${i}"]`).value;
      if(p.in==='path') url=url.replace('{'+p.name+'}',encodeURIComponent(v));
      else if(p.in==='query'&&v) qs.set(p.name,v);
    });
    if([...qs].length) url+='?'+qs.toString();
    const init={method:M,headers:{}};
    const ta=d.querySelector('[data-body]');
    if(ta&&ta.value.trim()){init.body=ta.value;init.headers['Content-Type']='application/json';}
    const out=d.querySelector('.resp');
    out.innerHTML='…';
    try{
      const t0=performance.now();
      const r=await fetch(url,init);
      const text=await r.text();
      let pretty=text;
      try{pretty=JSON.stringify(JSON.parse(text),null,2);}catch(e){}
      const cls=r.ok?'status-ok':'status-err';
      out.innerHTML=`<span class="${cls}">${r.status}</span> `+
        `<code>${esc(url)}</code> (${(performance.now()-t0).toFixed(0)} ms)`+
        `<pre>${esc(pretty)}</pre>`;
    }catch(e){ out.innerHTML=`<span class="status-err">network error</span> ${e}`; }
  });
  return d;
}
fetch('/.well-known/openapi.json').then(r=>r.json()).then(render);
</script></body></html>""".encode("utf-8")


def register_swagger_routes(app, static_dir: str = "./static") -> None:
    # resolve at registration: the handler re-reads per request (live spec
    # edits show up without restart), and a later os.chdir by the app must
    # not break a path captured relative to the boot cwd
    spec_path = os.path.abspath(os.path.join(static_dir, "openapi.json"))
    if not os.path.isfile(spec_path):
        return

    async def openapi_handler(_req: Request) -> Response:
        with open(spec_path, "rb") as f:
            body = f.read()
        return Response(200, [("Content-Type", "application/json")], body)

    async def ui_handler(_req: Request) -> Response:
        return Response(200, [("Content-Type", "text/html; charset=utf-8")], _UI_HTML)

    app.router.add("GET", "/.well-known/openapi.json", openapi_handler)
    app.router.add("GET", "/.well-known/swagger", ui_handler)
